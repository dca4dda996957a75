"""Port entry points on the CPU: the serve launcher at smoke size, the
CUDA default (which raises without a card), and the port's isolation
from JAX and from the JAX package."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import OffloadedMoEEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.runtime import resolve_device  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]


def test_run_on_cpu_at_smoke_size(capsys):
    rep = serve.main(["--arch", "granite-moe-1b-a400m-smoke", "--device", "cpu",
                      "--capacity", "2", "--batch", "2", "--prompt-len", "8",
                      "--max-new", "4", "--dtype", "float32"])
    assert rep["tokens"].shape == (2, 4)
    assert rep["prefill_logits"].shape == (2, 512)
    assert torch.isfinite(rep["prefill_logits"]).all()
    assert rep["decode_tokens"] == 4 and rep["transfers"] > 0
    assert rep["hits"] + rep["misses"] > 0
    assert rep["modeled_time_overlapped_s"] <= rep["modeled_time_s"]
    assert rep["hw"] == "h100-pcie5" and rep["device"] == "cpu"
    assert "transfers=" in capsys.readouterr().out
    # the same seed gives the same tokens; the plain backend is the same path
    again = serve.run("granite-moe-1b-a400m-smoke", capacity=2, batch=2,
                      prompt_len=8, max_new=4, dtype="float32", device="cpu",
                      kernel_backend="ref")
    np.testing.assert_array_equal(again["tokens"], rep["tokens"])


def test_a_cut_depth_name_resolves_to_the_first_layers():
    """``<arch>-<N>l`` names ``<arch>`` cut to its first N layers, in any
    process that resolves it (the fleet's workers, spawned children)."""
    import dataclasses

    full, cut = get_config("olmoe-mini"), get_config("olmoe-mini-2l")
    assert (cut.name, cut.n_layers, cut.n_moe_layers) == ("olmoe-mini-2l", 2, 2)
    assert dataclasses.replace(cut, name=full.name, layout=full.layout) == full
    assert get_config("mixtral-8x7b-8l").n_layers == 8
    for bad in ("olmoe-mini-9l", "olmoe-mini-0l"):
        with pytest.raises(ValueError, match="whole number"):
            get_config(bad)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch-2l")


def test_quantized_run_on_cpu_at_smoke_size(capsys):
    rep = serve.main(["--arch", "granite-moe-1b-a400m-smoke", "--device", "cpu",
                      "--capacity", "2", "--batch", "2", "--prompt-len", "8",
                      "--max-new", "4", "--dtype", "float32", "--quantized"])
    cfg = get_config("granite-moe-1b-a400m-smoke")
    d, f = cfg.d_model, cfg.moe_spec.d_ff
    # packed codes plus fp32 scale and zero per group of 32, for wg/wu/wd
    assert rep["quantized"]
    assert rep["expert_bytes"] == 3 * (d * f // 2 + 2 * 4 * d * f // 32)
    assert rep["quantize_s"] > 0 and rep["transfers"] > 0
    assert rep["tokens"].shape == (2, 4) and torch.isfinite(rep["prefill_logits"]).all()
    assert "INT4 experts" in capsys.readouterr().out
    # the same codes served again through the plain backend give the same tokens
    kept = serve.run("granite-moe-1b-a400m-smoke", capacity=2, batch=2, prompt_len=8,
                     max_new=4, dtype="float32", device="cpu", quantized=True,
                     keep_store=True)
    again = serve.run("granite-moe-1b-a400m-smoke", capacity=2, batch=2, prompt_len=8,
                      max_new=4, dtype="float32", device="cpu", quantized=True,
                      kernel_backend="ref", quantized_experts=kept["quantized_experts"])
    np.testing.assert_array_equal(kept["tokens"], rep["tokens"])
    np.testing.assert_array_equal(again["tokens"], rep["tokens"])
    assert again["transfers"] == rep["transfers"]


def test_prompts_match_the_jax_launcher():
    from repro.data.synthetic import ClusterLM, SyntheticConfig

    lm = ClusterLM(SyntheticConfig(vocab=4096, seq_len=20, seed=3))
    rng = np.random.default_rng(0)
    want = np.stack([lm.sample_sequence(rng)[0] for _ in range(3)]).astype(np.int32)
    np.testing.assert_array_equal(serve.make_prompts(4096, 3, 20), want)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    cfg = get_config("granite-moe-1b-a400m-smoke")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        OffloadedMoEEngine(cfg, params, capacity=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run("granite-moe-1b-a400m-smoke", max_new=2)
    assert resolve_device("cpu") == torch.device("cpu")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = _port_files() + sorted((ROOT / "tools").glob("*.py"))  # the chip tools too
    bad = {str(p.relative_to(ROOT)): pat.findall(p.read_text()) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in _port_files()[:-1]]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    assert {"repro_torch.core.quant", "repro_torch.kernels.int4_matmul.ops",
            "repro_torch.kernels.int4_matmul.ref", "repro_torch.bridge",
            "repro_torch.kernels.ssd_scan.ops", "repro_torch.kernels.ssd_scan.ref",
            "repro_torch.models.mamba2", "repro_torch.models.blocks",
            "repro_torch.inference.engine", "repro_torch.inference.sampling",
            "repro_torch.models.moe", "repro_torch.serving", "repro_torch.serving.server",
            "repro_torch.serving.scorers", "repro_torch.serving.profiling",
            "repro_torch.serving.queue", "repro_torch.serving.request",
            "repro_torch.serving.scheduler", "repro_torch.serving.batch",
            "repro_torch.serving.metrics", "repro_torch.launch.bench_serve",
            "repro_torch.core.cache_sim", "repro_torch.core.rank_match",
            "repro_torch.core.losses", "repro_torch.core.predictor",
            "repro_torch.training.optim", "repro_torch.training.trainer",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.core.baselines", "repro_torch.core.little_expert",
            "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.registry",
            "repro_torch.obs.reconcile", "repro_torch.obs.validate", "repro_torch.faults",
            "repro_torch.faults.plan", "repro_torch.faults.retry",
            "repro_torch.recovery.checkpoint", "repro_torch.recovery.journal",
            "repro_torch.recovery.audit", "repro_torch.fleet", "repro_torch.fleet.heartbeat",
            "repro_torch.fleet.worker", "repro_torch.fleet.supervisor",
            "repro_torch.launch.bench_fleet", "repro_torch.distributed",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.models.runtime", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
