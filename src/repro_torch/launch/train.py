"""Training launcher, PyTorch (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-mini \
        --steps 200 --mode both [--device cpu] [--dtype float32]

Pretrains a base model on the synthetic ClusterLM corpus (NLL), then
MELINOE-fine-tunes it (router + expert gate + LoRA, Eq. 6), and writes
the reference's two checkpoints in its byte format: ``<name>_base.ckpt``
(params only) and ``<name>_melinoe.ckpt`` (``(params, lora)``), each
with a ``_history.json`` beside it. ``--mode finetune`` alone asserts,
as the reference's does (it has no base to start from). Runs on ``cuda``
unless ``--device cpu``; the weights are drawn in ``--dtype`` (the
reference's float32 by default).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..configs import get_config
from ..data.synthetic import ClusterLM, SyntheticConfig
from ..models.common import cdtype
from ..models.runtime import resolve_device
from ..training.checkpoint import save_checkpoint
from ..training.optim import OptConfig
from ..training.trainer import melinoe_finetune, pretrain, train_runtime


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-mini")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mode", choices=["pretrain", "finetune", "both"], default="both")
    ap.add_argument("--ft-steps", type=int, default=100)
    ap.add_argument("--out", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    dev = resolve_device(args.device)
    rt = train_runtime(dev)
    lm = ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=args.seq, seed=args.seed))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    written = {}

    res = None
    if args.mode in ("pretrain", "both"):
        res = pretrain(cfg, lm.batches(args.batch, seed=args.seed + 1), steps=args.steps,
                       opt_cfg=OptConfig(peak_lr=args.lr, total_steps=args.steps,
                                         weight_decay=0.01),
                       rt=rt, seed=args.seed, device=dev, dtype=cdtype(args.dtype))
        path = out / f"{cfg.name}_base.ckpt"
        save_checkpoint(path, res.params, step=args.steps,
                        metadata={"arch": cfg.name, "stage": "pretrain"})
        (out / f"{cfg.name}_base_history.json").write_text(json.dumps(res.history))
        written["base"] = str(path)

    if args.mode in ("finetune", "both") and cfg.has_router:
        assert res is not None, "finetune mode requires --mode both here"
        ft = melinoe_finetune(cfg, res.params, lm.batches(args.batch, seed=args.seed + 2),
                              steps=args.ft_steps, rt=rt, seed=args.seed)
        path = out / f"{cfg.name}_melinoe.ckpt"
        save_checkpoint(path, (ft.params, ft.lora), step=args.ft_steps,
                        metadata={"arch": cfg.name, "stage": "melinoe"})
        (out / f"{cfg.name}_melinoe_history.json").write_text(json.dumps(ft.history))
        written["melinoe"] = str(path)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("done")
    return written


if __name__ == "__main__":
    main()
