"""How far a bf16 model's logits move when one op's rounding changes, at
reduced width and full depth: the sensitivity that decides what a
kernel-vs-plain logits gate can hold for a deep random model.

    PYTHONPATH=src python tools/roundoff.py --arch zamba2-7b \\
        --d-model 512 --mode noise --eps 3e-7 --tokens-seed 1
    PYTHONPATH=src python tools/roundoff.py --arch zamba2-7b \\
        --d-model 512 --mode round_y --tokens-seed 0 --device cpu

Builds ``--arch`` at ``--d-model`` with every layer (attention heads of
112, d_model // 112 of them; d_ff 4 d_model; vocab 4096), random bf16
weights from seed 0 on ``--device`` (default cuda), and runs the plain
path's forward over (2, 256) tokens twice, the second time with one
perturbation of the SSD scan (and, for ``noise``, of attention):

  noise    the scan output and the attention output (the plain path's
           ``blockwise_attention``) scaled by (1 + eps N(0, 1)) in fp32
           before they are rounded, as a kernel's other summation order
           would;
  round_y  the scan output rounded to the model dtype before the D skip
           is added, as a kernel without the fused skip would.

Prints rel = ||delta|| / ||plain|| of the last position's logits and the
top-1 agreement. Plain torch only; no kernel runs.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models import attention
from repro_torch.models.model import apply_model, init_params
from repro_torch.models.runtime import Runtime, resolve_device


def reduced(arch: str, d_model: int):
    cfg = get_config(arch)
    heads = max(1, d_model // 112)
    defs = {}
    for name, b in cfg.block_defs.items():
        attn = b.attn and dataclasses.replace(b.attn, n_heads=heads, n_kv_heads=heads,
                                              head_dim=112)
        defs[name] = dataclasses.replace(b, attn=attn, d_ff=4 * d_model if b.d_ff else 0)
    return dataclasses.replace(cfg, d_model=d_model, block_defs=defs, vocab=4096)


def logits_gap(arch: str, d_model: int, mode: str, eps: float = 3e-7,
               tokens_seed: int = 0, device=None) -> tuple:
    dev = resolve_device(device)
    cfg = reduced(arch, d_model)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(tokens_seed))
    noise = torch.Generator(device=dev).manual_seed(1)
    rt = Runtime(kernel_backend="ref", device=dev)
    ssd, blockwise = ssd_ops.ssd, attention.blockwise_attention

    def ssd_perturbed(x, dt, A, Bm, Cm, *, init=None, D=None, chunk=128, backend=None):
        y, state = ssd_chunked(x, dt, A, Bm, Cm, chunk, init)
        if mode == "round_y":
            y = y.to(x.dtype).float()
        else:
            y = y * (1 + eps * torch.randn(y.shape, generator=noise, device=dev))
        return (y + D.float()[None, None, :, None] * x.float()).to(x.dtype), state

    def attention_perturbed(q, k, v, *, softcap=None, window=None):
        o = blockwise(q.float(), k.float(), v.float(), softcap=softcap, window=window)
        return (o * (1 + eps * torch.randn(o.shape, generator=noise, device=dev))
                ).to(k.dtype)

    with torch.inference_mode():
        plain, _ = apply_model(params, cfg, toks, rt)
        ssd_ops.ssd = ssd_perturbed
        if mode == "noise":
            attention.blockwise_attention = attention_perturbed
        try:
            moved, _ = apply_model(params, cfg, toks, rt)
        finally:
            ssd_ops.ssd, attention.blockwise_attention = ssd, blockwise
    a, b = moved[:, -1].float().cpu(), plain[:, -1].float().cpu()
    return ((a - b).norm() / b.norm()).item(), (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--mode", choices=["noise", "round_y"], default="noise")
    ap.add_argument("--eps", type=float, default=3e-7)
    ap.add_argument("--tokens-seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rel, top1 = logits_gap(args.arch, args.d_model, args.mode, args.eps,
                           args.tokens_seed, args.device)
    print(f"{args.arch} d_model {args.d_model} {args.mode} eps {args.eps}: "
          f"rel {rel:.4g} top-1 {top1:.2f}")
    return rel, top1


if __name__ == "__main__":
    main()
