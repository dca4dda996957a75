"""Why an offloaded MoE model's fp32 prefill logits move between the kernel
path and the plain path: the order of sums, or a router's top-k choice that
flips between the two runs.

    PYTHONPATH=src python tools/route_flips.py --arch deepseek-moe-16b
    PYTHONPATH=src python tools/route_flips.py --arch deepseek-moe-16b-smoke \\
        --device cpu --prompt-len 16

Builds ``--arch`` (its first ``--layers`` layers; all by default) with fp32
weights from seed 0, the experts in host memory as the engines' store, and
runs ``OffloadedMoEEngine``'s prefill over the launcher's prompts (4 x
``--prompt-len``) four times:

  kernel          the "auto" backend (the kernels on a CUDA device);
  plain           the "ref" backend, attention through the port's plain
                  path (``blockwise_attention``);
  plain_ref_attn  the "ref" backend with attention through
                  ``kernels/flash_attn/ref.py::attention_ref`` instead;
  plain_replay    the "ref" backend (``blockwise_attention``), each layer
                  routed to the experts the kernel run chose, gates from its
                  own router.

Prints one JSON object: rel = ||a - b|| / ||b|| of the last prompt
position's logits for each pair, and for each plain run against the kernel
run the (token, layer) routes whose expert sets differ, the first MoE layer
where one does, and the smallest gap between a token's k-th and (k+1)-th
router probability in the kernel run.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core import offload_engine
from repro_torch.core.offload_engine import OffloadedMoEEngine
from repro_torch.kernels.flash_attn import attention_ref
from repro_torch.launch.serve import make_prompts
from repro_torch.models import attention
from repro_torch.models.model import init_params
from repro_torch.models.moe import top_k_route
from repro_torch.models.runtime import resolve_device


def cut(arch: str, layers):
    cfg = get_config(arch)
    if layers is None:
        return cfg
    *head, last = cfg.layout
    rest = layers - sum(g.n_layers for g in head)
    return dataclasses.replace(cfg, name=f"{arch}-{layers}l", layout=(
        *head, dataclasses.replace(last, repeats=rest // len(last.pattern))))


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def prefills(arch: str, layers=None, prompt_len: int = 128, capacity: int = 16,
             device=None) -> dict:
    dev = resolve_device(device)
    cfg = cut(arch, layers)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev, expert_device="cpu")
    store = [{k: bp["ffn"][k][r] for k in ("wg", "wu", "wd")}
             for gi, g in enumerate(cfg.layout) for r in range(g.repeats)
             for pi, bname in enumerate(g.pattern)
             if cfg.block_defs[bname].kind == "attn_moe"
             for bp in (params["groups"][f"g{gi}"][f"p{pi}"],)]
    prompts = make_prompts(cfg.vocab, 4, prompt_len)
    blockwise = attention.blockwise_attention
    routes: dict = {}
    logits: dict = {}

    def ref_attn(q, k, v, *, softcap=None, window=None):
        return attention_ref(q, k, v, softcap=softcap, window=window).to(k.dtype)

    for name, backend in (("kernel", "auto"), ("plain", "ref"),
                          ("plain_ref_attn", "ref"), ("plain_replay", "ref")):
        seen, replay = [], routes.get("kernel")

        def route(probs, k):
            gates, eids = top_k_route(probs, k)
            if replay is not None and name == "plain_replay":
                eids = replay[len(seen)][0].to(eids.device)
                gates = probs.gather(-1, eids.long())
            top = torch.topk(probs, k + 1, dim=-1).values
            seen.append((eids.cpu(), (top[:, k - 1] - top[:, k]).cpu()))
            return gates, eids

        offload_engine.top_k_route = route
        if name == "plain_ref_attn":
            attention.blockwise_attention = ref_attn
        try:
            eng = OffloadedMoEEngine(cfg, params, capacity=capacity, policy="gamma",
                                     host_store=store, kernel_backend=backend, device=dev)
            logits[name] = eng.generate(prompts, max_new_tokens=1)["prefill_logits"
                                                                  ].float().cpu()
            del eng
        finally:
            offload_engine.top_k_route = top_k_route
            attention.blockwise_attention = blockwise
        routes[name] = seen
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    out = {"arch": cfg.name, "prompt_len": prompt_len, "moe_layers": len(routes["kernel"]),
           "min_topk_gap_kernel": min(g.min().item() for _, g in routes["kernel"])}
    for a, b in (("kernel", "plain"), ("kernel", "plain_ref_attn"),
                 ("plain", "plain_ref_attn"), ("kernel", "plain_replay")):
        out[f"rel_{a}_vs_{b}"] = rel(logits[a], logits[b])
    for name in ("plain", "plain_ref_attn", "plain_replay"):
        diff = [(e.sort(-1).values != f.sort(-1).values).any(-1)
                for (e, _), (f, _) in zip(routes["kernel"], routes[name])]
        layers_hit = [i for i, d in enumerate(diff) if d.any()]
        out[f"route_flips_{name}"] = int(sum(d.sum().item() for d in diff))
        out[f"first_flip_layer_{name}"] = layers_hit[0] if layers_hit else None
        out[f"flip_gaps_{name}"] = sorted(
            g[d].min().item() for d, (_, g) in zip(diff, routes["kernel"]) if d.any())[:8]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--layers", type=int, default=None, help="the first N layers (all)")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--capacity", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = prefills(args.arch, args.layers, args.prompt_len, args.capacity, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
