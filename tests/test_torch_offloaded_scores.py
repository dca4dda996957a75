"""The oracle scores streamed one MoE layer at a time out of the engine's
host store (``serving.prefill_expert_scores(host_store=...)``, each
layer staged by ``core.offload_engine.stage_experts``), and
``bench_serve --offloaded`` built on it, on the CPU:

* the streamed scores are bit-equal to the whole-tree pass on
  mixtral-8x7b-smoke and olmoe-mini, in fp32 and bf16, with and without a
  LoRA tree, and stage each MoE layer once whatever the number of
  requests; within 1e-5 (fp32) of the JAX package's
  ``prefill_expert_scores`` on the same weights (``bridge.params_from_jax``);
* ``bench_serve --offloaded`` (fcfs and expert-affinity, ``--ckpt``,
  ``--engine-impl dict``, ``--little``) gives the tokens, transfers,
  prefetch transfers, hit counts and both modeled clocks of the whole-tree
  construction: the whole draw (or read), the whole-tree oracle, an
  ``OffloadedWaveServer`` built from the tree;
* an INT4 store is not staged (``NotImplementedError``);
* in a subprocess at the inflated config of ``tests/_torch_rss.py`` (604
  MB of fp32 experts), ``bench_serve --offloaded``'s resident-set
  high-water mark as serving starts stays below its baseline + the store
  + one layer of experts + the non-expert weights (the whole-tree
  construction holds every expert twice: the tree and the store).
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_rss import run_child  # noqa: E402
from _torch_wave import lora_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import prefill_expert_scores as jax_prefill_expert_scores  # noqa: E402
from repro.serving.request import ServeRequest as JaxServeRequest  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lora import lora_scale  # noqa: E402
from repro_torch.core.offload_engine import (HostExpertStore, OffloadedMoEEngine,  # noqa: E402
                                             stage_experts)
from repro_torch.data.synthetic import ClusterLM, SyntheticConfig  # noqa: E402
from repro_torch.launch import bench_serve  # noqa: E402
from repro_torch.launch.serve import load_params, offloaded_params  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import scorers  # noqa: E402
from repro_torch.training import save_checkpoint  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _prompts(cfg, lengths=(5, 9, 7), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]


def _requests(prompts):
    return [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=1)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def draws():
    """Per config and dtype, drawn once for the module's tests (the oracle
    reads the trees and the store and writes none of them): the seed's tree
    with its experts (the whole tree), and the same draw offloaded (params
    with meta experts, the host store)."""
    memo = {}

    def get(cfg, dtype):
        if (cfg.name, dtype) not in memo:
            whole = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                                device="cpu")
            params, store, _ = offloaded_params(cfg, dtype=dtype, device="cpu")
            memo[cfg.name, dtype] = whole, params, store
        return memo[cfg.name, dtype]

    yield get
    memo.clear()


@pytest.mark.parametrize("lora", [False, True], ids=["nolora", "lora"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke", "olmoe-mini"])
def test_streamed_oracle_is_bit_equal_to_the_whole_tree(monkeypatch, draws, arch, dtype, lora):
    cfg = get_config(arch)
    whole, params, store = draws(cfg, dtype)
    assert all(params["groups"]["g0"][p]["ffn"][k].is_meta
               for p in params["groups"]["g0"] for k in ("wg", "wu", "wd"))
    kw = {}
    if lora:
        kw = dict(lora=lora_from_jax(cfg, lora_tree(cfg, 1), dtype=dtype),
                  lora_scale=lora_scale(cfg.melinoe))
    staged = []

    def counted(layer, device):
        staged.append(1)
        return stage_experts(layer, device)

    monkeypatch.setattr(scorers, "stage_experts", counted)
    prompts = _prompts(cfg)
    want = serving.prefill_expert_scores(cfg, whole, _requests(prompts), **kw)
    assert staged == []
    reqs = _requests(prompts)
    got = serving.prefill_expert_scores(cfg, params, reqs, host_store=store, **kw)
    assert len(staged) == cfg.n_moe_layers
    for g, w, r in zip(got, want, reqs):
        assert g.shape == (cfg.n_moe_layers, cfg.moe_spec.num_experts)
        np.testing.assert_array_equal(g, w)
        assert r.expert_scores is g
    # one staging a MoE layer, whatever the number of requests
    staged.clear()
    serving.prefill_expert_scores(cfg, params, _requests(_prompts(cfg, (4,) * 7, seed=1)),
                                  host_store=store, **kw)
    assert len(staged) == cfg.n_moe_layers


@pytest.mark.parametrize("lora", [False, True], ids=["nolora", "lora"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke", "olmoe-mini"])
def test_streamed_oracle_matches_the_jax_reference(arch, lora):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    # the bridged experts into an engine's store; the tree's own are not read
    store = OffloadedMoEEngine(tcfg, tparams, capacity=2, device="cpu").host_store
    jkw, tkw = {}, {}
    if lora:
        lt = lora_tree(jcfg, 1)
        sc = lora_scale(tcfg.melinoe)
        jkw = dict(lora=jax.tree.map(jnp.asarray, lt), lora_scale=sc)
        tkw = dict(lora=lora_from_jax(tcfg, lt), lora_scale=sc)
    prompts = _prompts(tcfg, (8, 8, 8))
    want = jax_prefill_expert_scores(
        jcfg, jparams, [JaxServeRequest(rid=i, prompt=p) for i, p in enumerate(prompts)],
        **jkw)
    got = serving.prefill_expert_scores(tcfg, tparams, _requests(prompts),
                                        host_store=store, **tkw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_an_int4_store_is_not_staged():
    cfg = get_config("mixtral-8x7b-smoke")
    store = HostExpertStore(cfg, quantized=True, device="cpu")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu", expert_sink=store.sink)
    layers = store.finish()
    with pytest.raises(NotImplementedError, match="INT4"):
        stage_experts(layers[0], "cpu")
    with pytest.raises(NotImplementedError, match="INT4"):
        serving.prefill_expert_scores(cfg, params, _requests(_prompts(cfg)),
                                      host_store=layers)


def test_stage_experts_copies_each_matrix_contiguous():
    cfg = get_config("olmoe-mini-smoke")
    _, store, _ = offloaded_params(cfg, dtype=torch.bfloat16, device="cpu")
    for layer in store:
        got = stage_experts(layer, "cpu")
        for k, v in layer.items():
            assert got[k].is_contiguous() and not v.is_contiguous()
            assert got[k].data_ptr() != v.data_ptr()
            assert torch.equal(got[k], v)


# -- bench_serve --offloaded against the whole-tree construction ----------

SMOKE = ["--device", "cpu", "--dtype", "float32", "--offloaded", "--capacity", "2",
         "--n-requests", "5", "--slots", "2", "--prompt-len", "10", "--max-new", "5",
         "--arrival", "all_at_once"]


def _whole_tree(argv, params):
    """``bench_serve``'s workload, scored on the whole tree ``params`` and
    served by a wave server built from it."""
    args = bench_serve._parser().parse_args(argv)
    cfg = get_config(args.arch)
    lm = ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=args.prompt_len * 2,
                                   seed=args.seed + 3))
    requests = serving.synthesize_workload(lm, serving.TrafficConfig(
        n_requests=args.n_requests, arrival=args.arrival, rate=args.rate,
        prompt_len=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new_tokens=(max(args.max_new // 2, 1), args.max_new),
        temperature=args.temperature, seed=args.seed, slo=args.slo, quality=args.quality))
    serving.prefill_expert_scores(cfg, params, requests)
    capacity = args.capacity or cfg.melinoe_cache_capacity()
    kw = {"top_c": capacity} if args.scheduler == "expert-affinity" else {}
    srv = serving.OffloadedWaveServer(
        cfg, params, capacity=capacity,
        scheduler=serving.get_scheduler(args.scheduler, **kw), wave_size=args.slots,
        overlap=args.overlap, engine_impl=args.engine_impl, little_experts=args.little,
        little_rank=args.little_rank, seed=args.seed, device="cpu")
    return srv.run(serving.RequestQueue(requests))


def _same_serve(got, want):
    (res, mt), (wres, wmt) = got, want
    assert [(r.rid, r.tokens.tolist(), r.finish_reason) for r in res] == \
        [(r.rid, r.tokens.tolist(), r.finish_reason) for r in wres]
    for k in ("transfers", "transfer_bytes", "prefetch_transfers", "cache_hits",
              "cache_misses", "modeled_time_serial", "modeled_time_overlapped",
              "modeled_time", "degraded_requests", "generated_tokens"):
        assert getattr(mt, k) == getattr(wmt, k), k
    assert mt.transfers > 0


@pytest.mark.parametrize("case", [
    ("mixtral-8x7b-smoke", ["--scheduler", "fcfs"]),
    ("mixtral-8x7b-smoke", ["--scheduler", "expert-affinity", "--overlap"]),
    ("olmoe-mini", ["--scheduler", "expert-affinity", "--capacity", "8", "--n-requests", "3",
                    "--prompt-len", "8", "--max-new", "3"]),
    ("olmoe-mini-smoke", ["--engine-impl", "dict"]),
    ("olmoe-mini-smoke", ["--little", "--quality", "0.5", "--scheduler", "expert-affinity"]),
], ids=["fcfs", "affinity", "olmoe-mini-affinity", "dict", "little"])
def test_bench_serve_offloaded_gives_the_whole_tree_serve(capsys, case):
    arch, extra = case
    argv = ["--arch", arch, *SMOKE, *extra]
    got = bench_serve.main(argv)
    err = capsys.readouterr().err
    cfg = get_config(arch)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    _same_serve(got, _whole_tree(argv, params))
    assert got[1].prefetch_transfers > 0
    if "--little" in extra:
        assert got[1].degraded_requests > 0
    line = next(ln for ln in err.splitlines() if ln.startswith(bench_serve.BUILD_LINE))
    build = json.loads(line[len(bench_serve.BUILD_LINE):])
    spec = cfg.moe_spec
    assert build["host_store_bytes"] == cfg.n_moe_layers * spec.num_experts * 3 \
        * cfg.d_model * spec.d_ff * 4
    assert build["build_s"] > 0 and build["score_s"] > 0
    assert set(build["served_launches"]) == {"prefill", "decode"}


def test_bench_serve_offloaded_ckpt_gives_the_whole_tree_serve(tmp_path, capsys):
    arch = "olmoe-mini-smoke"
    cfg = get_config(arch)
    path = tmp_path / "w.ckpt"
    save_checkpoint(path, init_params(cfg, generator=torch.Generator().manual_seed(5),
                                      dtype=torch.float32, device="cpu"))
    argv = ["--arch", arch, *SMOKE, "--scheduler", "expert-affinity", "--ckpt", str(path)]
    got = bench_serve.main(argv)
    assert f"loaded {path}" in capsys.readouterr().out
    params, _ = load_params(cfg, path, dtype=torch.float32, device="cpu")
    assert not params["groups"]["g0"]["p0"]["ffn"]["wg"].is_meta
    _same_serve(got, _whole_tree(argv, params))


# bench_serve --offloaded at the inflated config: 3 requests of up to 4
# tokens, C = 1, one new token each.
BENCH_BODY = r"""
bench_serve.main(["--arch", "mixtral-8x7b-smoke", "--device", "cpu", "--dtype", "float32",
                  "--offloaded", "--capacity", "1", "--n-requests", "3", "--slots", "1",
                  "--prompt-len", "4", "--max-new", "1", "--arrival", "all_at_once",
                  "--scheduler", "expert-affinity"])
print(json.dumps({"baseline": baseline, "build_rss": probe[0],
                  "store_bytes": cfg.n_moe_layers * layer_bytes, "layer_bytes": layer_bytes,
                  "nonexpert_bytes": nonexpert_bytes}))
"""


def bench_serve_rss(src: Path, timeout_s: float = 300.0) -> dict:
    """Run the launcher against the package under ``src`` in a fresh process."""
    return run_child(BENCH_BODY, src, timeout_s)


def test_bench_serve_offloaded_holds_the_experts_once():
    r = bench_serve_rss(ROOT / "src")
    assert r["store_bytes"] >= 512 * 2**20
    limit = r["baseline"] + r["store_bytes"] + r["layer_bytes"] + r["nonexpert_bytes"]
    assert r["build_rss"] < limit, r
