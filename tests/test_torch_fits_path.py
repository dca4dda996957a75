"""The port's full-model (fits-in-memory) path for the SSM and hybrid
families — bridge, init_params, apply_model, prefill/decode_step and
ServingEngine — against the JAX package on the CPU, at smoke size.

Weights are JAX ``init_params`` trees carried across by the bridge;
tokens are drawn with numpy. The JAX side runs its plain path
(``Runtime(kernel_backend="ref")``). Tolerances, fp32: logits 1e-4 (many
products deep, another summation order); prefill + decode against the
full forward 5e-3, as ``tests/test_decode_consistency.py`` (the
recurrent step against the chunked form). Greedy tokens are identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.inference.engine import Request as JaxRequest  # noqa: E402
from repro.inference.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.models import Runtime as JaxRuntime, apply_model as jax_apply_model  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import FP32_LEAVES, params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.inference import Request, ServingEngine, truncate_at_stop  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ARCHS = ["mamba2-130m-smoke", "zamba2-7b-smoke"]
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
CPU = Runtime(device=torch.device("cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    arch = request.param
    jcfg = jax_get_config(arch)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg, jnp.float32))
    return jcfg, get_config(arch), tree, params_from_jax(tree, get_config(arch))


def _paths(tree):
    return [(jax.tree_util.keystr(p), x.shape, str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def test_zamba2_bridge_round_trip_and_fp32_ssm_leaves():
    jcfg = jax_get_config("zamba2-7b-smoke")
    tcfg = get_config("zamba2-7b-smoke")
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(1), jcfg))  # bf16
    assert "shared" in tree and "p1" not in tree["groups"]["g0"]
    back = params_to_numpy(params_from_jax(tree, tcfg))
    assert [p for p, _, _ in _paths(tree)] == [p for p, _, _ in _paths(back)]
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    # an fp32 tree cast to bf16 keeps the SSM's decay, skip and dt bias in fp32
    tree32 = jax.tree.map(np.asarray, jax_init_params(jax.random.key(1), jcfg,
                                                      jnp.float32))
    params = params_from_jax(tree32, tcfg, dtype="bfloat16")
    mixer = params["groups"]["g0"]["p0"]["mixer"]
    for k in ("A_log", "D", "dt_bias"):
        assert k in FP32_LEAVES and mixer[k].dtype == torch.float32, k
        np.testing.assert_array_equal(mixer[k].numpy(),
                                      tree32["groups"]["g0"]["p0"]["mixer"][k])
    assert mixer["in_proj"].dtype == torch.bfloat16
    assert params["shared"]["mixer"]["wq"].dtype == torch.bfloat16
    exact = params_to_numpy(params_from_jax(tree32, tcfg))
    for a, b in zip(jax.tree.leaves(tree32), jax.tree.leaves(exact)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_a_tree_without_its_shared_block():
    jcfg = jax_get_config("zamba2-7b-smoke")
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(1), jcfg, jnp.float32))
    del tree["shared"]
    with pytest.raises(KeyError, match="shared"):
        params_from_jax(tree, get_config("zamba2-7b-smoke"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_jax_tree_layout(bridged, dtype):
    jcfg, tcfg, _, _ = bridged
    tree = jax.eval_shape(lambda k: jax_init_params(k, jcfg, jnp.dtype(dtype)),
                          jax.random.key(0))
    mine = tmodel.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                              dtype=dtype, device="cpu")
    want = [(p, tuple(s), d) for p, s, d in _paths(tree)]
    got = [(p, tuple(s), d.replace("torch.", "")) for p, s, d in
           [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(mine)]]
    assert got == want


def test_apply_model_logits_match_jax_ref(bridged):
    jcfg, tcfg, tree, params = bridged
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 45)).astype(np.int32)
    jl, _ = jax_apply_model(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks),
                            JaxRuntime(kernel_backend="ref"))
    tl, _ = tmodel.apply_model(params, tcfg, torch.as_tensor(toks).long(), CPU)
    assert tl.dtype == torch.float32 and tl.shape == (2, 45, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)


def test_prefill_then_decode_matches_full_forward(bridged):
    _, tcfg, _, params = bridged
    B, T, G = 2, 24, 6
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, tcfg.vocab, (B, T + G)))
    full, _ = tmodel.apply_model(params, tcfg, toks, CPU)
    lg, cache = tmodel.prefill(params, tcfg, toks[:, :T], CPU, n_slots=T + G)
    assert cache["pos"] == T
    outs = [lg]
    for i in range(G):
        lg, cache, _ = tmodel.decode_step(params, tcfg, toks[:, T + i: T + i + 1], cache,
                                          CPU)
        outs.append(lg)
    assert cache["pos"] == T + G
    err = (torch.cat(outs, dim=1) - full[:, T - 1:]).abs().max().item()
    assert err < 5e-3, err
    # init_cache has prefill's layout
    empty = tmodel.init_cache(tcfg, B, T + G, dtype=torch.float32, device="cpu")
    for g in empty:
        if g != "pos":
            for p in empty[g]:
                assert [t.shape for t in empty[g][p]] == [t.shape for t in cache[g][p]]


def test_serving_engine_gives_the_jax_engines_greedy_tokens(bridged):
    """The slice as a whole: the same requests (ragged prompts, so left
    padding, and a stop token) through both engines give the same tokens."""
    jcfg, tcfg, tree, params = bridged
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n in (12, 9, 12)]
    max_new = (8, 5, 8)
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            rt=JaxRuntime(kernel_backend="ref", zero_drop=True))
    jout = jeng.generate_batch([JaxRequest(p, m) for p, m in zip(prompts, max_new)])
    stop = (int(jout[0].tokens[3]),)
    jout = jeng.generate_batch([JaxRequest(p, m, stop_tokens=stop)
                                for p, m in zip(prompts, max_new)])
    teng = ServingEngine(tcfg, params)
    tout = teng.generate_batch([Request(p, m, stop_tokens=stop)
                                for p, m in zip(prompts, max_new)])
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert t.finish_reason == j.finish_reason
    assert tout[0].finish_reason == "stop"


def test_engine_and_full_path_refuse_what_is_not_ported(bridged):
    """Sampling and router probes are ported (tests/test_torch_serving.py,
    tests/test_torch_moe.py), and so is LoRA (tests/test_torch_lora.py:
    here a model without experts, where a LoRA tree has nothing to
    adapt), and remat (tests/test_torch_train.py; here it gives the
    logits of the plain forward), and prefix embeddings (here their rows
    reach the logits as in the JAX package; the dense and
    prefix-conditioned configs in tests/test_torch_dense*.py), and the
    offload engine's ``impl="dict"`` (tests/test_torch_engine_dict.py) and
    expert parallelism (tests/test_torch_distributed.py). The dry-run has
    no entry point in the port yet."""
    jcfg, tcfg, tree, params = bridged
    toks = torch.zeros((1, 4), dtype=torch.long)
    req = [Request(np.arange(4, dtype=np.int32), 3)]
    np.testing.assert_array_equal(
        ServingEngine(tcfg, params, lora={}).generate_batch(req)[0].tokens,
        ServingEngine(tcfg, params).generate_batch(req)[0].tokens)
    torch.testing.assert_close(tmodel.apply_model(params, tcfg, toks, CPU, remat=True)[0],
                               tmodel.apply_model(params, tcfg, toks, CPU)[0],
                               rtol=0, atol=0)
    prefix = np.random.default_rng(8).standard_normal((1, 2, tcfg.d_model)).astype(np.float32)
    with_prefix, _ = tmodel.apply_model(params, tcfg, toks, CPU,
                                        prefix_embed=torch.as_tensor(prefix))
    jl, _ = jax_apply_model(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks.numpy()),
                            JaxRuntime(kernel_backend="ref"), prefix_embed=jnp.asarray(prefix))
    assert with_prefix.shape == (1, 6, tcfg.vocab)
    np.testing.assert_allclose(with_prefix.numpy(), np.asarray(jl), **TOL_LOGITS)
    plain, _ = tmodel.apply_model(params, tcfg, toks, CPU)
    assert (with_prefix[:, 2:] - plain).abs().max().item() > 1e-3  # the rows reach the tokens
    caches = [tmodel.prefill(params, tcfg, toks, CPU, n_slots=6)[1] for _ in range(2)]
    lg_lora, _, _ = tmodel.decode_step(params, tcfg, toks[:, :1], caches[0], CPU, lora={})
    lg, _, _ = tmodel.decode_step(params, tcfg, toks[:, :1], caches[1], CPU)
    assert torch.equal(lg_lora, lg)
    # a model without a router has no probes to give
    out = ServingEngine(tcfg, params).generate_batch(
        [Request(np.arange(4, dtype=np.int32), 3)], collect_probs=True)
    assert out[0].router_probs is None and len(out[0].tokens) == 3


def test_attn_moe_waits_for_its_slice():
    """The attn_moe slice has landed: a MoE config runs through
    apply_model and run_full (tests/test_torch_moe.py holds the numbers);
    so have its LoRA adapters (tests/test_torch_lora.py): a tree with
    ``b`` = 0, as the init draws it, leaves the logits as they are."""
    from repro_torch.core.lora import init_lora

    cfg = get_config("granite-moe-1b-a400m-smoke")
    params = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    logits, _ = tmodel.apply_model(params, cfg, toks, CPU)
    assert logits.shape == (1, 4, cfg.vocab) and torch.isfinite(logits).all()
    lora = init_lora(cfg, cfg.melinoe, generator=torch.Generator().manual_seed(1))
    with_lora, _ = tmodel.apply_model(params, cfg, toks, CPU, lora=lora, lora_scale=0.5)
    assert torch.equal(with_lora, logits)
    rep = serve.run_full("granite-moe-1b-a400m-smoke", batch=2, prompt_len=8, max_new=3,
                         dtype="float32", device="cpu")
    assert rep["path"] == "full" and rep["tokens"].shape == (2, 3)


def test_truncate_at_stop():
    assert truncate_at_stop(np.array([3, 5, 7, 5]), (5,))[1] == "stop"
    np.testing.assert_array_equal(truncate_at_stop(np.array([3, 5, 7]), (5,))[0], [3, 5])
    assert truncate_at_stop(np.array([3, 4]), (5,))[1] == "length"


def test_run_full_on_cpu_at_smoke_size(capsys):
    """The launcher's full-model path: report, launches of each phase
    (none on the CPU), and the same tokens as the serving engine."""
    rep = serve.main(["--arch", "zamba2-7b-smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "40", "--max-new", "5", "--dtype", "float32"])
    assert rep["path"] == "full" and rep["tokens"].shape == (2, 5)
    assert rep["prefill_logits"].shape == (2, 512)
    assert torch.isfinite(rep["prefill_logits"]).all()
    assert rep["prefill_s"] > 0 and rep["decode_tok_s"] > 0
    assert all(n == 0 for ph in rep["launches"].values() for n in ph.values())
    assert "full-model path" in capsys.readouterr().out
    kept = serve.run_full("zamba2-7b-smoke", batch=2, prompt_len=40, max_new=5,
                          dtype="float32", device="cpu", keep_params=True)
    np.testing.assert_array_equal(kept["tokens"], rep["tokens"])  # same seed
    cfg = get_config("zamba2-7b-smoke")
    prompts = serve.make_prompts(cfg.vocab, 2, 40)
    comps = ServingEngine(cfg, kept["params"]).generate_batch(
        [Request(p, 5) for p in prompts])
    np.testing.assert_array_equal(np.stack([c.tokens for c in comps]), rep["tokens"])


def _roundoff_tool():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "roundoff.py"
    spec = importlib.util.spec_from_file_location("roundoff", path)
    roundoff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roundoff)
    return roundoff


def test_roundoff_tool_perturbs_and_restores():
    """tools/roundoff.py on the CPU: no perturbation moves nothing; a
    rounding of the scan output moves the bf16 logits; the patched
    functions are put back."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import attention

    roundoff = _roundoff_tool()
    before = (ssd_ops.ssd, attention.blockwise_attention)
    assert roundoff.logits_gap("zamba2-7b-smoke", 112, "noise", eps=0.0,
                               device="cpu")[0] == 0.0
    rel, top1 = roundoff.logits_gap("zamba2-7b-smoke", 112, "round_y", device="cpu")
    assert 0.0 < rel < 1.0 and 0.0 <= top1 <= 1.0
    assert (ssd_ops.ssd, attention.blockwise_attention) == before


def test_route_flips_tool_on_the_cpu():
    """tools/route_flips.py on the CPU, where the "auto" backend runs the
    plain versions: the kernel and plain runs agree exactly and route
    alike, attention_ref moves the logits only by round-off, replaying
    the kernel run's routes changes nothing, and the patched functions
    are put back."""
    import importlib.util
    import pathlib

    from repro_torch.configs import get_config
    from repro_torch.core import offload_engine
    from repro_torch.models import attention

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "route_flips.py"
    spec = importlib.util.spec_from_file_location("route_flips", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    before = (offload_engine.top_k_route, attention.blockwise_attention)
    out = tool.prefills("deepseek-moe-16b-smoke", prompt_len=16, capacity=4, device="cpu")
    assert out["moe_layers"] == get_config("deepseek-moe-16b-smoke").n_moe_layers
    assert out["rel_kernel_vs_plain"] == 0.0 and out["rel_kernel_vs_plain_replay"] == 0.0
    assert 0.0 <= out["rel_kernel_vs_plain_ref_attn"] < 1e-5
    assert out["route_flips_plain"] == out["route_flips_plain_replay"] == 0
    assert (offload_engine.top_k_route, attention.blockwise_attention) == before


def test_peak_site_tool_accounts_for_the_peak():
    """tools/peak_site.py's ledger on a small whole-model train step: the
    record is the dry run's own, its last look lies within the step
    fraction of the peak, the bytes by site add up to that look, and the
    dry run's ledger is put back."""
    import importlib.util
    import pathlib

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.runtime import Runtime

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "peak_site.py"
    spec = importlib.util.spec_from_file_location("peak_site", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg, shape = get_config("olmoe-mini-smoke"), ShapeSpec("train_small", 64, 4, "train")
    kept = dryrun.Ledger
    plain = dryrun.dry_run(cfg, shape, Runtime(device="cpu"))
    with tool.sites(0.01) as seen:
        rec = dryrun.dry_run(cfg, shape, Runtime(device="cpu"))
    assert dryrun.Ledger is kept
    out = tool.summary(rec, seen["ledger"], 3)
    assert out["peak_bytes"] == plain["memory_analysis"]["peak_bytes"]
    assert rec["flops_per_device"] == plain["flops_per_device"]
    assert out["peak_bytes"] / 1.01 <= out["looked_at"] <= out["peak_bytes"]
    assert sum(seen["ledger"].snapshot["by"].values()) == out["looked_at"]
    assert len(out["live_by_site"]) == 3 and out["peak_set_by"]


def test_roundoff_tool_noise_moves_the_attention_output():
    """The ``noise`` mode perturbs attention on the plain path as well as
    the scan: on a model with no scan (qwen3) eps > 0 moves the logits and
    eps = 0 leaves them as they are."""
    from repro_torch.models import attention

    roundoff = _roundoff_tool()
    before = attention.blockwise_attention
    assert roundoff.logits_gap("qwen3-4b-smoke", 112, "noise", eps=0.0, device="cpu")[0] == 0.0
    rel, _ = roundoff.logits_gap("qwen3-4b-smoke", 112, "noise", eps=1e-2, device="cpu")
    assert 0.0 < rel < 1.0
    assert attention.blockwise_attention is before
