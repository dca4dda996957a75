"""Training loops, counterpart of ``repro/training/trainer.py``:
pretraining a base MoE on the synthetic corpus, the MELINOE fine-tuning
stage (Sec 3.1), held-out NLL, and ``merge_lora``, which bakes a
fine-tune's LoRA deltas into the expert weights (the checkpoint
``examples/train_melinoe.py`` serves).

The trainer's kernel spec is :data:`TRAIN_KERNEL_BACKEND`: ``moe_gmm``
runs its Hopper kernel forward and backward (``kernels.moe_gmm.GmmFn``)
on a CUDA tensor; ``flash_attn``, ``ssd_scan`` and ``int4_matmul`` have
no backward in either package and train through their plain versions,
as every op of the reference's ``Runtime()`` does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.lora import extract_base_routers, init_lora, melinoe_trainable_mask
from ..models.model import apply_model, init_params
from ..models.runtime import Runtime, resolve_device
from .optim import OptConfig, init_opt_state

TRAIN_KERNEL_BACKEND = "auto,flash_attn=ref,ssd_scan=ref,int4_matmul=ref"


def train_runtime(device) -> Runtime:
    """The trainer's Runtime: :data:`TRAIN_KERNEL_BACKEND` on ``device``."""
    return Runtime(kernel_backend=TRAIN_KERNEL_BACKEND, device=torch.device(device))


@dataclass
class TrainResult:
    params: dict
    history: List[Dict[str, float]] = field(default_factory=list)
    lora: Optional[dict] = None

    def last(self, key: str) -> float:
        return self.history[-1][key]


def _log(tag: str, i: int, metrics: dict, t0: float, history: list, verbose: bool):
    m = {k: float(v) for k, v in metrics.items()}
    m["step"] = i
    m["time"] = time.time() - t0
    history.append(m)
    if verbose:
        print(f"[{tag} {i:5d}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))


def pretrain(cfg: ModelConfig, data_iter, *, steps: int, opt_cfg: Optional[OptConfig] = None,
             rt: Optional[Runtime] = None, seed: int = 0, melinoe_aux: bool = False,
             log_every: int = 50, params: Optional[dict] = None, verbose: bool = True,
             device=None, dtype=torch.float32) -> TrainResult:
    """Standard LM pretraining (NLL only by default): builds the *base*
    model whose weak per-sequence expert preferences MELINOE amplifies.
    ``params`` given are trained in place; else fp32 (``dtype``) weights
    are drawn from ``seed`` on ``device`` (None: cuda)."""
    from ..launch.steps import build_train_step  # the steps import training.optim

    dev = params["embed"].device if params is not None else resolve_device(device)
    rt = rt or train_runtime(dev)
    opt_cfg = opt_cfg or OptConfig(peak_lr=3e-3, total_steps=steps, weight_decay=0.01)
    if params is None:
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                             dtype=dtype, device=dev)
    opt_state = init_opt_state(params)
    step_fn = build_train_step(cfg, rt, opt_cfg, melinoe=melinoe_aux)
    history: list = []
    t0 = time.time()
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data_iter))
        if i % log_every == 0 or i == steps - 1:
            _log("pretrain", i, metrics, t0, history, verbose)
    return TrainResult(params=params, history=history)


def _finetune_copy(tree, mask):
    """The fine-tune's parameter tree: trainable leaves (router, expert
    ``wg``) copied, frozen ones shared with the base. The copies are made
    here, outside any ``inference_mode`` region, so that autograd can save
    them even where the base was made inside one."""
    if isinstance(tree, dict):
        return {k: _finetune_copy(v, mask[k]) for k, v in tree.items()}
    return tree.clone() if mask else tree


def melinoe_finetune(cfg: ModelConfig, base_params, data_iter, *, steps: int,
                     opt_cfg: Optional[OptConfig] = None, rt: Optional[Runtime] = None,
                     seed: int = 0, log_every: int = 50,
                     verbose: bool = True) -> TrainResult:
    """Pre-deployment stage (Sec 3.1.1): router + expert gate full update,
    LoRA on expert up/down, L = L_nll + l_cs L_cs + l_rm L_rm.

    Only the trainable leaves are copied (the reference copies the whole
    tree: at OLMoE-1B-7B's width another 13.8 GB in bf16); ``base_params``
    is left as it is. The adapters are drawn from ``seed + 1`` on the
    model's device (the reference's draw depends on ``PYTHONHASHSEED``;
    parity runs drive ``launch.steps.build_finetune_step`` with a bridged
    tree)."""
    from ..launch.steps import build_finetune_step

    assert cfg.melinoe is not None and cfg.has_router
    dev = base_params["embed"].device
    rt = rt or train_runtime(dev)
    opt_cfg = opt_cfg or OptConfig(peak_lr=3e-3, total_steps=steps, min_lr_frac=0.1)
    mask = melinoe_trainable_mask(base_params)
    params = _finetune_copy(base_params, mask)
    lora = init_lora(cfg, cfg.melinoe,
                     generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    base_routers = extract_base_routers(base_params, cfg)
    opt_state = init_opt_state((params, lora), (mask, True))
    step_fn = build_finetune_step(cfg, rt, opt_cfg, mask)
    history: list = []
    t0 = time.time()
    for i in range(steps):
        params, lora, opt_state, metrics = step_fn(params, lora, opt_state,
                                                   next(data_iter), base_routers)
        if i % log_every == 0 or i == steps - 1:
            _log("melinoe", i, metrics, t0, history, verbose)
    return TrainResult(params=params, history=history, lora=lora)


def _copy_dicts(tree):
    return {k: _copy_dicts(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def merge_lora(cfg: ModelConfig, params, lora, scale: float):
    """A new parameter tree (the input is left as it is; untouched leaves
    are shared) whose expert ``wu``/``wd`` are ``w + scale * a @ b`` cast
    to ``w``'s dtype. The product runs where the adapters live, one
    repeat at a time, and the result goes where ``w`` lives."""
    out = _copy_dicts(params)
    for gi, g in enumerate(cfg.layout):
        gname = f"g{gi}"
        for pi, bname in enumerate(g.pattern):
            if cfg.block_defs[bname].moe is None or f"p{pi}" not in lora.get(gname, {}):
                continue
            ffn = out["groups"][gname][f"p{pi}"]["ffn"]
            lt = lora[gname][f"p{pi}"]
            for t in ("wu", "wd"):
                w = ffn[t]
                merged = torch.empty_like(w)
                for r in range(w.shape[0]):
                    delta = torch.einsum("edk,ekf->edf", lt[t]["a"][r], lt[t]["b"][r])
                    merged[r] = w[r] + (scale * delta).to(w.dtype).to(w.device)
                ffn[t] = merged
    return out


@torch.no_grad()
def eval_nll(cfg: ModelConfig, params, batches, rt: Optional[Runtime] = None,
             lora=None, scale: float = 1.0) -> float:
    """Mean next-token NLL over ``batches`` (numpy batches of
    ``data.synthetic``)."""
    from ..core.losses import nll_loss
    from ..launch.steps import device_batch

    dev = params["embed"].device
    rt = rt or train_runtime(dev)
    vals = []
    for b in batches:
        batch = device_batch(b, dev)
        logits, _ = apply_model(params, cfg, batch["tokens"], rt, lora=lora,
                                lora_scale=scale)
        vals.append(float(nll_loss(logits[:, :-1], batch["labels"][:, 1:])))
    return float(np.mean(vals))
