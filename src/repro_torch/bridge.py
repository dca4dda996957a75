"""Weight bridge between the JAX parameter tree and the port's dicts.

The JAX ``init_params`` tree (``groups/g{gi}/p{pi}`` leaves stacked over
``repeats``, plus ``embed``, ``lm_head``, ``final_norm`` and, for a model
with a shared-attention block, ``shared``) maps key for key onto the
port's dict. A ``shared_attn`` position has no ``p{pi}`` entry: its
weights live once, under ``shared``. The bridge takes and returns numpy
arrays only, so it needs neither JAX nor its bf16 type: a JAX bfloat16 array
(an ``ml_dtypes`` dtype named ``"bfloat16"``) crosses as float32, which
holds every bf16 value exactly.

INT4 weights cross the same way: :func:`qtensor_from_jax` takes a numpy
copy of a JAX ``QTensor`` (``repro.core.quant``), and
:func:`quantized_experts_from_jax` turns a JAX quantized engine's host
store into the port engine's ``quantized_experts`` argument, so that the
two packages compute on the same codes. A JAX little-expert bank
(``repro.core.little_expert.LittleExpertBank``) crosses with
:func:`little_bank_from_jax`: its fp32 factors as they are, its INT4 left
factors on their codes.

LoRA trees cross with :func:`lora_from_jax` (``{g: {p: {"wu"|"wd":
{"a": (R, E, din, r), "b": (R, E, r, dout)}}}}``, numpy leaves), the
activation predictor's weights with :func:`predictor_from_jax`.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.little_expert import LittleExpertBank
from .core.quant import QTensor, matmul_layout
from .kernels.int4_matmul.ops import MatmulQWeight
from .models.common import cdtype


# leaves kept in fp32 at any model dtype, as the JAX init keeps them
FP32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def _check_layout(tree: dict, cfg: ModelConfig) -> None:
    shared = any(b.kind == "shared_attn" for b in cfg.block_defs.values())
    want = {"embed", "final_norm", "groups"} | (
        set() if cfg.tie_embeddings else {"lm_head"}) | ({"shared"} if shared else set())
    missing = want - set(tree)
    if missing:
        raise KeyError(f"parameter tree lacks {sorted(missing)}")
    for gi, g in enumerate(cfg.layout):
        for pi, bname in enumerate(g.pattern):
            if cfg.block_defs[bname].kind == "shared_attn":
                continue  # weights live under "shared"
            if f"p{pi}" not in tree["groups"].get(f"g{gi}", {}):
                raise KeyError(f"parameter tree lacks groups/g{gi}/p{pi}")


def _to_torch(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # e.g. a leaf of training.load_checkpoint
        t = a if dtype is None or not a.is_floating_point() else a.to(dtype)
        return t.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)  # a copy: JAX hands out read-only buffers
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, cfg: ModelConfig, *, dtype=None, device="cpu"):
    """Numpy tree (``jax.tree.map(np.asarray, params)``; CPU tensors, as
    ``training.load_checkpoint`` returns them, cross too) -> torch dict.

    ``dtype``: cast floating leaves to it, except the fp32 leaves of
    :data:`FP32_LEAVES` (router, and the SSM's A_log, D, dt_bias), as in
    the JAX init; ``None`` keeps each leaf's dtype."""
    _check_layout(tree, cfg)
    dt = cdtype(dtype) if dtype is not None else None

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _to_torch(node, None if key in FP32_LEAVES else dt, device)

    return walk(tree)


def lora_from_jax(cfg: ModelConfig, tree, *, dtype=None, device="cpu"):
    """Numpy LoRA tree (``jax.tree.map(np.asarray, lora)``) -> torch dict,
    checked against the config's MoE positions and expert shapes.
    ``dtype``: cast every leaf to it; ``None`` keeps each leaf's dtype."""
    dt = cdtype(dtype) if dtype is not None else None
    out = {}
    for g, gtree in tree.items():
        gi = int(g[1:])
        group = cfg.layout[gi]
        out[g] = {}
        for p, ptree in gtree.items():
            b = cfg.block_defs[group.pattern[int(p[1:])]]
            if b.moe is None:
                raise KeyError(f"lora {g}/{p}: block {b.kind!r} has no experts")
            E, d, f = b.moe.num_experts, cfg.d_model, b.moe.d_ff
            dims = {"wu": (d, f), "wd": (f, d)}
            out[g][p] = {}
            for t, ab in ptree.items():
                din, dout = dims[t]
                a, bb = np.asarray(ab["a"]), np.asarray(ab["b"])
                r = a.shape[-1]
                if a.shape != (group.repeats, E, din, r) or \
                        bb.shape != (group.repeats, E, r, dout):
                    raise ValueError(f"lora {g}/{p}/{t}: a {a.shape} b {bb.shape} do not "
                                     f"fit (R={group.repeats}, E={E}, {din}->{dout})")
                out[g][p][t] = {"a": _to_torch(a, dt, device), "b": _to_torch(bb, dt, device)}
    return out


def predictor_from_jax(tree, *, device="cpu") -> dict:
    """A JAX ``init_predictor``/``train_predictor`` tree (``w1``, ``b1``,
    ``w2``, ``b2`` as arrays, ``_dims`` (L, E)) -> the port's, fp32 on
    ``device``."""
    out = {k: _to_torch(tree[k], torch.float32, device) for k in ("w1", "b1", "w2", "b2")}
    out["_dims"] = tuple(int(d) for d in tree["_dims"])
    return out


def params_to_numpy(params) -> dict:
    """Torch dict -> numpy tree (bf16 leaves come back as float32)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return walk(params)


def qtensor_from_jax(qt) -> QTensor:
    """A numpy copy of a JAX ``QTensor`` (any 5-field sequence: packed,
    scale, zero, shape, group; shape and group may be 0-d arrays) -> the
    port's QTensor, bit for bit."""
    packed, scale, zero, shape, group = qt
    return QTensor(torch.tensor(np.asarray(packed)),
                   torch.tensor(np.asarray(scale)), torch.tensor(np.asarray(zero)),
                   tuple(int(s) for s in shape), int(group))


def qtensor_to_numpy(qt: QTensor) -> tuple:
    """Port QTensor -> (packed, scale, zero, shape, group) with numpy leaves."""
    return (qt.packed.cpu().numpy(), qt.scale.cpu().numpy(), qt.zero.cpu().numpy(),
            tuple(qt.shape), int(qt.group))


def quantized_experts_from_jax(host_store) -> list:
    """A JAX quantized engine's ``host_store`` (per MoE layer, expert id ->
    ``{"q": {k: QTensor}}``) -> per layer ``{k: MatmulQWeight}`` of
    ``(E, ...)`` leaves in the matmul layout (``OffloadedMoEEngine(...,
    quantized_experts=...)``)."""
    out = []
    for store in host_store:
        per_e = [{k: matmul_layout(qtensor_from_jax(q))
                  for k, q in store[e]["q"].items()} for e in sorted(store)]
        out.append({k: MatmulQWeight(*(torch.stack([m[k][i] for m in per_e])
                                       for i in range(3)), per_e[0][k].group)
                    for k in per_e[0]})
    return out


def little_bank_from_jax(bank, *, device="cpu") -> LittleExpertBank:
    """A JAX ``LittleExpertBank`` (per layer ``{k: (left, right)}``: left
    ``(E, din, r)`` fp32 or, quantized, the ``QTensor`` of ``left^T``;
    right ``(E, r, dout)``) -> the port's bank on ``device``, every factor
    and code bit for bit (INT4 left factors in the matmul layout)."""
    factors = []
    for layer in bank.factors:
        out = {}
        for k, (left, right) in layer.items():
            left = (matmul_layout(qtensor_from_jax(left)) if bank.quantized
                    else torch.tensor(np.asarray(left)))
            out[k] = (left, torch.tensor(np.asarray(right)))
        factors.append(out)
    return LittleExpertBank.from_factors(factors, rank=bank.rank, quantized=bank.quantized,
                                         device=device)
