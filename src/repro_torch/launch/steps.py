"""Step builders, counterpart of ``repro/launch/steps.py``: train,
fine-tune, prefill and decode, and the placement trees of their
arguments.

The placement trees are the reference's ``NamedSharding`` trees for its
pjit: :func:`ns_tree` turns a spec tree into a tree of DTensor
placements (a tuple of ``Placement``, one per mesh dim, at each spec),
:func:`train_shardings` gives those of (params, opt state, batch) and
:func:`decode_shardings` those of (params, {tokens, cache}). The dry run
(``launch/dryrun.py``) places its arguments through them; a step run on
whole tensors places them itself (``distribute_params``,
:func:`place_batch`), to the same placements.

On a sharded ``Runtime`` the steps run on DTensors: parameters (and
optimizer moments, ``init_opt_state`` of the placed parameters) placed by
``distributed.sharding.distribute_params``, and a batch that every rank
holds whole placed by ``batch_pspecs`` inside the step (a ``cache`` given
to the decode step comes from the sharded prefill). The train step
recomputes each repeat in the backward pass there (``remat=rt.sharded``,
as the reference).

A training step is a plain function: the forward pass, ``torch.autograd.grad``
over the trainable leaves only, then the masked AdamW update
(``training.optim``), in place. The trainable leaves enter the forward
as detached views that require grad, one per repeat of a stacked leaf,
so that each repeat's gradient is its own tensor (no full-size zero
tensor per repeat, as indexing one stacked autograd leaf would give).
The trees passed in come back updated; nothing else is copied. Frozen
leaves get no gradient at all (the reference computes theirs and masks
them to zero, which leaves the same update and clip norm).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..configs.base import ModelConfig
from ..core.losses import combine, next_token_shift, nll_loss, nll_loss_on_mesh
from ..distributed.sharding import (batch_pspecs, cache_pspecs, distribute, param_pspecs,
                                    placements)
from ..models.model import MelinoeRun, apply_model, decode_step, param_shapes
from ..models.runtime import Runtime, is_distributed
from ..training.optim import OptConfig, adamw_update, global_norm


def _shift_loss(logits, tokens, labels, prefix_len: int):
    """Next-token NLL with the prefix-embedding offset. On a sharded mesh
    each rank takes its own batch rows and, where the logits are split
    along the vocab, its own block of it (``nll_loss_on_mesh``)."""
    if is_distributed(logits):
        return nll_loss_on_mesh(logits, labels, prefix_len)
    start, tgt = next_token_shift(labels, prefix_len)
    return nll_loss(logits[:, start:start + tgt.shape[1]], tgt)


def device_batch(batch: dict, device) -> dict:
    """A batch of numpy arrays (``data.synthetic``) as tensors on
    ``device``: integers for the token arrays, ``prefix_embed`` as it is;
    the ``cluster`` labels are dropped."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=None if k == "prefix_embed" else torch.long)
            for k, v in batch.items() if k != "cluster"}


def place_batch(batch: dict, rt: Runtime) -> dict:
    """On a sharded ``rt``, the batch's tensors as DTensors of
    ``batch_pspecs`` (each rank keeps its rows); as they are otherwise."""
    if not rt.sharded:
        return batch
    specs = batch_pspecs(batch, rt)
    return {k: v if is_distributed(v) else distribute(v, specs[k], rt.mesh)
            for k, v in batch.items()}


def ns_tree(rt: Runtime, spec_tree):
    """A spec tree (dicts and named tuples of specs) -> the same tree of
    placements on ``rt.mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``)."""
    if isinstance(spec_tree, dict):
        return {k: ns_tree(rt, v) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):  # KVCache, MambaState
        return type(spec_tree)(*(ns_tree(rt, v) for v in spec_tree))
    return placements(spec_tree, rt.mesh)


def train_shardings(cfg: ModelConfig, rt: Runtime, batch_specs):
    """(params, opt_state, batch) placement trees for the train step; the
    moments ``mu``/``nu`` as the parameters, ``step`` replicated (the
    port's ``training.optim.init_opt_state`` of placed parameters keys its
    moments by leaf path and places each as its parameter)."""
    pspec = param_pspecs(param_shapes(cfg), cfg, rt)
    opt_spec = {"mu": pspec, "nu": pspec, "step": ()}
    return (ns_tree(rt, pspec), ns_tree(rt, opt_spec),
            ns_tree(rt, batch_pspecs(batch_specs, rt)))


def decode_shardings(cfg: ModelConfig, rt: Runtime, batch_specs):
    """(params, {tokens, cache}) placement trees for the decode step."""
    pspec = param_pspecs(param_shapes(cfg), cfg, rt)
    bspec = {"tokens": batch_pspecs(batch_specs["tokens"], rt),
             "cache": cache_pspecs(batch_specs["cache"], rt)}
    return ns_tree(rt, pspec), ns_tree(rt, bspec)


def make_loss_fn(cfg: ModelConfig, rt: Runtime, *, melinoe: bool):
    """loss_fn(params, batch) -> (loss, metrics). With ``melinoe`` (and a
    config that has a router and a MELINOE spec) the loss is Eq. 6, the
    base routers being the current ones, detached."""
    use_mel = melinoe and cfg.has_router and cfg.melinoe is not None

    def loss_fn(params, batch):
        mel = None
        if use_mel:
            from ..core.lora import extract_base_routers

            mel = MelinoeRun(spec=cfg.melinoe, cache_capacity=cfg.melinoe_cache_capacity(),
                             base_routers=extract_base_routers(params, cfg))
        logits, aux = apply_model(params, cfg, batch["tokens"], rt,
                                  prefix_embed=batch.get("prefix_embed"), melinoe=mel,
                                  remat=rt.sharded)
        with rt.dist():
            nll = _shift_loss(logits, batch["tokens"], batch["labels"], cfg.prefix_len)
        if use_mel:
            total = combine(nll, aux["cs_loss"], aux["rm_loss"], cfg.melinoe)
            return total, {"nll": nll, "cs_loss": aux["cs_loss"],
                           "rm_loss": aux["rm_loss"], "loss": total}
        return nll, {"nll": nll, "loss": nll}

    return loss_fn


def build_prefill_step(cfg: ModelConfig, rt: Runtime, *, n_slots: Optional[int] = None,
                       window_override: Optional[int] = None):
    """fn(params, batch) -> (last-position logits (B, 1, V), cache): the
    batch's ``tokens`` after its ``prefix_embed`` rows, if it has them, into
    a cache of ``n_slots`` positions (None: the prompt's own length)."""

    def step(params, batch):
        batch = place_batch(batch, rt)
        logits, aux = apply_model(params, cfg, batch["tokens"], rt,
                                  prefix_embed=batch.get("prefix_embed"),
                                  want_cache=True, cache_slots=n_slots or 0,
                                  window_override=window_override)
        return logits[:, -1:], aux["cache"]

    return step


def build_decode_step(cfg: ModelConfig, rt: Runtime, *,
                      window_override: Optional[int] = None):
    """fn(params, batch) -> (logits (B, 1, V), cache): one token
    (``batch["tokens"]`` (B, 1)) through ``batch["cache"]``, which is
    updated in place and returned."""

    def step(params, batch):
        tokens = place_batch({"tokens": batch["tokens"]}, rt)["tokens"]
        logits, cache, _ = decode_step(params, cfg, tokens, batch["cache"], rt,
                                       window_override=window_override)
        return logits, cache

    return step


class _Views:
    """A tree's trainable leaves as autograd leaves: :meth:`tree` is a copy
    of the dict structure in which each trainable leaf is a detached view
    that requires grad (a list of one view per repeat where the leaf is
    stacked), frozen leaves as they are; :meth:`grads` turns the gradients
    of :attr:`inputs` back into a tree of the same shape (``None`` at
    frozen leaves, a list of per-repeat gradients at stacked ones)."""

    def __init__(self, tree, mask, stacked: Callable[[str], bool]):
        self.inputs: List[torch.Tensor] = []

        def walk(t, m, path):
            if isinstance(t, dict):
                return {k: walk(v, m[k] if isinstance(m, dict) else m,
                                f"{path}/{k}" if path else k) for k, v in t.items()}
            if not m:
                return t
            if stacked(path):
                vs = [x.detach().requires_grad_() for x in t]
                self.inputs += vs
                return vs
            v = t.detach().requires_grad_()
            self.inputs.append(v)
            return v

        self.tree = walk(tree, mask, "")

    def grads(self, grads_by_id: dict):
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, list):
                return [grads_by_id[id(x)] for x in t]
            return grads_by_id.get(id(t))

        return walk(self.tree)


def _grads(loss, views: List[_Views]) -> list:
    inputs = [x for v in views for x in v.inputs]
    gs = torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)
    by_id = {id(x): g for x, g in zip(inputs, gs)}
    return [v.grads(by_id) for v in views]


def _params_stacked(path: str) -> bool:
    return path.startswith("groups/")


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def build_train_step(cfg: ModelConfig, rt: Runtime, opt_cfg: OptConfig, *,
                     melinoe: bool = True):
    """Full-parameter training step (pretrain / integrated-technique mode).
    fn(params, opt_state, batch) -> (params, opt_state, metrics); params
    and opt_state are updated in place (``opt_state`` from
    ``training.optim.init_opt_state(params)``).
    ``step.loss_and_grads(params, batch)`` gives the loss, metrics and
    gradients (per-repeat lists at stacked leaves) without updating
    anything."""
    loss_fn = make_loss_fn(cfg, rt, melinoe=melinoe)

    def loss_and_grads(params, batch):
        batch = place_batch(device_batch(batch, params["embed"].device), rt)
        with rt.dist():  # the backward (remat's recompute) too
            views = _Views(params, True, _params_stacked)
            loss, metrics = loss_fn(views.tree, batch)
            (grads,) = _grads(loss, [views])
        return loss, metrics, grads

    def step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, batch)
        with rt.dist():
            gn = global_norm(grads)
            _, opt_state, om = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, dict(_detached(metrics), grad_norm=gn, lr=om["lr"])

    step.loss_and_grads = loss_and_grads
    return step


def build_finetune_step(cfg: ModelConfig, rt: Runtime, opt_cfg: OptConfig, mask):
    """MELINOE fine-tuning step (router + expert gate + LoRA trainable; Sec
    3.1.1). fn(params, lora, opt_state, batch, base_routers) -> (params,
    lora, opt_state, metrics); the trainable leaves of ``params`` (those
    ``mask``, ``core.lora.melinoe_trainable_mask``, marks), the LoRA tree
    and ``opt_state`` (``init_opt_state((params, lora), (mask, True))``)
    are updated in place. ``base_routers``: the frozen base routers
    (``core.lora.extract_base_routers`` of the base model).
    ``step.loss_and_grads(params, lora, batch, base_routers)`` gives the
    loss, metrics and gradients without updating anything, ``step.loss``
    the loss and metrics of the forward pass alone."""
    assert cfg.has_router and cfg.melinoe is not None
    from ..core.lora import lora_scale

    spec = cfg.melinoe
    scale = lora_scale(spec)

    def loss_fn(params, lora, batch, base_routers):
        mel = MelinoeRun(spec=spec, cache_capacity=cfg.melinoe_cache_capacity(),
                         base_routers=base_routers)
        logits, aux = apply_model(params, cfg, batch["tokens"], rt,
                                  prefix_embed=batch.get("prefix_embed"), melinoe=mel,
                                  lora=lora, lora_scale=scale)
        nll = _shift_loss(logits, batch["tokens"], batch["labels"], cfg.prefix_len)
        total = combine(nll, aux["cs_loss"], aux["rm_loss"], spec)
        return total, {"nll": nll, "cs_loss": aux["cs_loss"], "rm_loss": aux["rm_loss"],
                       "loss": total}

    def loss_and_grads(params, lora, batch, base_routers):
        """(loss, metrics, (params grads, lora grads)) at the current
        weights, no update: ``None`` at frozen leaves, per-repeat lists at
        stacked ones."""
        batch = device_batch(batch, params["embed"].device)
        pv = _Views(params, mask, _params_stacked)
        lv = _Views(lora, True, lambda path: True)
        loss, metrics = loss_fn(pv.tree, lv.tree, batch, base_routers)
        return loss, metrics, tuple(_grads(loss, [pv, lv]))

    def loss(params, lora, batch, base_routers):
        """(loss, metrics) at the current weights, the forward pass only."""
        return loss_fn(params, lora, device_batch(batch, params["embed"].device),
                       base_routers)

    def step(params, lora, opt_state, batch, base_routers):
        _, metrics, grads = loss_and_grads(params, lora, batch, base_routers)
        adamw_update(grads, opt_state, (params, lora), opt_cfg, mask=(mask, True))
        return params, lora, opt_state, _detached(metrics)

    step.loss, step.loss_and_grads = loss, loss_and_grads
    return step
