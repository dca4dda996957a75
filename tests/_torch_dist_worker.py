"""The worker of ``tests/test_torch_distributed.py``: one rank of a (2, 2)
("data", "model") mesh over gloo on the CPU. Imports torch and the port
only (no JAX): the test computes its references in its own process.

``run(rank, world, port, root)`` reads ``root/inputs.pt`` (the same on
every rank), runs every sharded case, and rank 0 writes the gathered
results to ``root/results.pt``. Every collective (a ``full_tensor``
included) runs on all ranks. ``run_model`` runs the model cases alone on
the input's mesh (``tests/test_torch_distributed_mamba.py``), ``run_mlp``
the shared MLP's body (``tests/test_torch_shared_mlp.py``),
``run_vocab_loss`` the loss on vocab-split logits
(``tests/test_torch_vocab_loss.py``).
"""
import copy

import torch
import torch.distributed as dist

TRAIN_OPT = dict(peak_lr=1e-3, total_steps=10)
DECODE_STEPS = 4


def _full(tree):
    """A tree of DTensors (per-repeat lists stacked) as whole tensors."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack([_full(x) for x in tree])
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def _train(inp, rt):
    """The step's gradients at the initial weights, then the step itself."""
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.optim import OptConfig, init_opt_state

    params = distribute_params(copy.deepcopy(inp["params"]), inp["cfg"], rt)
    batch = {"tokens": inp["train_tokens"], "labels": inp["train_tokens"]}
    step = build_train_step(inp["cfg"], rt, OptConfig(**TRAIN_OPT), melinoe=True)
    _, _, grads = step.loss_and_grads(params, batch)
    grads = _full(grads)
    params, _, m = step(params, init_opt_state(params), batch)
    return {"loss": _full(m["loss"]).item(), "grad_norm": _full(m["grad_norm"]).item(),
            "grads": grads, "params": _full(params)}


def _serve(inp, rt):
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.launch.steps import build_decode_step, build_prefill_step

    params = distribute_params(inp["params"], inp["cfg"], rt)
    toks = inp["serve_tokens"]
    with torch.no_grad():
        logits, cache = build_prefill_step(inp["cfg"], rt, n_slots=toks.shape[1] + DECODE_STEPS)(
            params, {"tokens": toks})
        first = _full(logits)
        out = [first.argmax(-1)]
        decode = build_decode_step(inp["cfg"], rt)
        for _ in range(DECODE_STEPS):
            logits, cache = decode(params, {"tokens": out[-1], "cache": cache})
            out.append(_full(logits).argmax(-1))
    return {"prefill_logits": first[:, 0], "tokens": torch.cat(out, 1)}


def _moe(inp, rt, lora=None):
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models.moe import apply_moe_sharded

    mesh = rt.mesh
    p = inp["moe_params"]
    dp = {"router": distribute(p["router"], (None, None), mesh),
          **{k: distribute(p[k], ("model", None, None), mesh) for k in ("wg", "wu", "wd")}}
    dl = None if lora is None else {
        k: {f: distribute(t, ("model", None, None), mesh) for f, t in ab.items()}
        for k, ab in lora.items()}
    x = distribute(inp["moe_x"], ("data", None), mesh)
    with rt.dist():
        y, _ = apply_moe_sharded(dp, x, inp["moe_spec"], rt, lora=dl, lora_scale=0.5)
    return {"y": y.full_tensor(), "placements": tuple(y.placements)}


def _mlp(case, rt):
    """``mlp.apply_mlp_sharded`` on one case of ``root/inputs.pt``'s
    ``mlp_cases``: its weights placed by the sharding rules of zamba2's
    shared MLP (``fsdp``: with the data-axis split of FSDP), x and the
    output's gradient by batch rows. Returns y and the gradients of x and
    each weight, whole."""
    from repro_torch.distributed.sharding import distribute, leaf_spec
    from repro_torch.models.mlp import apply_mlp_sharded

    dp = {}
    for k, t in case["weights"].items():
        spec = leaf_spec(f"shared/ffn/{k}", t, fsdp=case["placement"] == "fsdp",
                         data_axes=rt.data_axes)
        dp[k] = distribute(t.clone().requires_grad_(), rt.prune_spec(t.shape, spec), rt.mesh)
    rows = (rt.data_axes, None, None)
    x = distribute(case["x"].clone().requires_grad_(), rows, rt.mesh)
    with rt.dist():
        y = apply_mlp_sharded(dp, x, rt)
        grads = torch.autograd.grad(y, [x, *dp.values()],
                                    distribute(case["dy"], rows, rt.mesh))
    return {"y": y.full_tensor().detach(),
            "placements": {k: str(v.placements) for k, v in dp.items()},
            "grads": dict(zip(["x", *dp], (g.full_tensor().detach() for g in grads)))}


def run_mlp(rank, world, port, root):
    """Every case of ``mlp_cases`` on the ("pod",) "data", "model" ``mesh``
    of ``root/inputs.pt``; rank 0 writes ``root/results.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.runtime import Runtime

        inp = torch.load(f"{root}/inputs.pt", weights_only=False)
        *pod, data, model = inp["mesh"]
        rt = Runtime(kernel_backend="ref", device=torch.device("cpu"),
                     mesh=make_debug_mesh(data, model, *pod, device_type="cpu"))
        res = {name: _mlp(case, rt) for name, case in inp["mlp_cases"].items()}
        if rank == 0:
            torch.save(res, f"{root}/results.pt")
    finally:
        dist.destroy_process_group()


def _vocab_loss(case, rt):
    """``core.losses.nll_loss_on_mesh`` on one case of ``root/inputs.pt``'s
    ``loss_cases``: the logits placed as ``compute_logits`` places them
    (``rules``: rows over the data axes, the vocab over "model" where it
    divides) or split along the vocab over "model" whatever its size
    (``forced``: torch.chunk's uneven blocks), the labels by batch rows.
    Returns the loss and the logits' gradient, whole."""
    from repro_torch.core.losses import nll_loss_on_mesh
    from repro_torch.distributed.sharding import distribute

    lg = case["logits"]
    spec = (rt.data_axes, None, "model")
    if case["placement"] == "rules":
        spec = rt.prune_spec(lg.shape, spec)
    dl = distribute(lg.clone().requires_grad_(), spec, rt.mesh)
    labels = distribute(case["labels"], (rt.data_axes, None), rt.mesh)
    with rt.dist():
        loss = nll_loss_on_mesh(dl, labels, case["prefix_len"])
        (grad,) = torch.autograd.grad(loss, [dl])
    return {"loss": loss.full_tensor().detach(), "grad": grad.full_tensor().detach(),
            "placements": str(tuple(dl.placements))}


def run_vocab_loss(rank, world, port, root):
    """Every case of ``loss_cases`` on the ("pod",) "data", "model"
    ``mesh`` of ``root/inputs.pt``; rank 0 writes ``root/results.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.runtime import Runtime

        inp = torch.load(f"{root}/inputs.pt", weights_only=False)
        *pod, data, model = inp["mesh"]
        rt = Runtime(kernel_backend="ref", device=torch.device("cpu"),
                     mesh=make_debug_mesh(data, model, *pod, device_type="cpu"))
        res = {name: _vocab_loss(case, rt) for name, case in inp["loss_cases"].items()}
        if rank == 0:
            torch.save(res, f"{root}/results.pt")
    finally:
        dist.destroy_process_group()


def run_model(rank, world, port, root):
    """The model cases alone (train and serve under the "tp" profile), for
    the config in ``root/inputs.pt``, on its ("data", "model") ``mesh``
    (default (2, 2))."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.runtime import Runtime

        inp = torch.load(f"{root}/inputs.pt", weights_only=False)
        tp = Runtime(kernel_backend="ref", device=torch.device("cpu"),
                     mesh=make_debug_mesh(*inp.get("mesh", (2, 2)), device_type="cpu"))
        res = {"train_tp": _train(inp, tp), "serve_tp": _serve(inp, tp)}
        if rank == 0:
            torch.save(res, f"{root}/results.pt")
    finally:
        dist.destroy_process_group()


def run(rank, world, port, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.common import set_opt_flags
        from repro_torch.models.runtime import Runtime

        inp = torch.load(f"{root}/inputs.pt", weights_only=False)
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        tp = Runtime(kernel_backend="ref", device=torch.device("cpu"), mesh=mesh)
        fsdp = Runtime(kernel_backend="ref", device=torch.device("cpu"), mesh=mesh,
                       profile="pure_fsdp")
        moe_rt = Runtime(kernel_backend="ref", device=torch.device("cpu"), mesh=mesh,
                         zero_drop=True)
        res = {"moe": _moe(inp, moe_rt), "moe_lora": _moe(inp, moe_rt, inp["moe_lora"])}
        set_opt_flags(moe_dispatch_shard=True)
        try:
            res["moe_dispatch_shard"] = _moe(inp, moe_rt)
        finally:
            set_opt_flags(moe_dispatch_shard=False)
        res["train_tp"] = _train(inp, tp)
        res["serve_tp"] = _serve(inp, tp)
        res["train_pure_fsdp"] = _train(inp, fsdp)
        res["serve_pure_fsdp"] = _serve(inp, fsdp)
        set_opt_flags(loss_token_shard=True)
        try:
            res["train_loss_token_shard"] = _train(inp, tp)
        finally:
            set_opt_flags(loss_token_shard=False)
        set_opt_flags(moe_dispatch_shard=True)
        try:
            res["train_moe_dispatch_shard"] = _train(inp, tp)
        finally:
            set_opt_flags(moe_dispatch_shard=False)
        if rank == 0:
            torch.save(res, f"{root}/results.pt")
    finally:
        dist.destroy_process_group()
