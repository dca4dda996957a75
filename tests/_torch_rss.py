"""A subprocess that builds an offloaded model at an inflated config and
reports its resident-set high-water mark as serving starts: shared by
``tests/test_torch_store_build.py``, ``test_torch_offloaded_scores.py``
and ``test_torch_ckpt_stream.py``.

The config is a reduced Mixtral: 3 layers of 8 experts at d_model 128,
d_ff 16,384, in fp32: 67 MB a matrix, 201 MB a layer, 604 MB of experts.
``PRELUDE`` makes it the config of every launcher in the child, and
records VmHWM (this process's own high-water mark: ``ru_maxrss`` starts
at the resident set of the process that forked it) at the first
``OffloadedMoEEngine.generate`` call, after the whole build, into
``probe``. On the CPU the device is the host, so the working memory of
drawing one matrix (torch's truncated-normal rejection sampler holds
about four of them at once) is host memory too: ``baseline`` is read after
one such draw, freed. The child runs with MALLOC_MMAP_THRESHOLD_ at 1 MiB
so that glibc hands every freed large block back (it otherwise keeps some
for reuse, and the resident set would count them as held). A body
appended to ``PRELUDE`` prints one JSON line last.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

PRELUDE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from _torch_rss import inflated_config
from repro_torch.core import offload_engine
from repro_torch.launch import bench_serve, serve
from repro_torch.models.common import dense_init
from repro_torch.models.model import init_params

def rss():
    for line in open("/proc/self/status"):
        if line.startswith("VmHWM:"):
            return int(line.split()[1]) * 1024

cfg = inflated_config()
serve.get_config = bench_serve.get_config = lambda name: cfg
probe = []
_generate = offload_engine.OffloadedMoEEngine.generate

def _probed(self, *a, **k):
    if not probe:
        probe.append(rss())
    return _generate(self, *a, **k)

offload_engine.OffloadedMoEEngine.generate = _probed
spec = cfg.moe_spec
layer_bytes = spec.num_experts * 3 * cfg.d_model * spec.d_ff * 4
shapes = init_params(cfg, generator=torch.Generator(), dtype=torch.float32, device="meta")
def _nbytes(t):
    return sum(_nbytes(v) for v in t.values()) if isinstance(t, dict) else t.numel() * 4
nonexpert_bytes = _nbytes(shapes) - cfg.n_moe_layers * layer_bytes
dense_init(cfg.d_model, spec.d_ff, torch.float32, generator=torch.Generator(),
           device="cpu", lead=(spec.num_experts,))
baseline = rss()
"""


def inflated_config():
    """The config of ``PRELUDE``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayoutGroup

    base = get_config("mixtral-8x7b-smoke")
    b = base.block_defs["moe"]
    return dataclasses.replace(
        base, block_defs={"moe": dataclasses.replace(
            b, moe=dataclasses.replace(b.moe, num_experts=8, d_ff=16384))},
        layout=(LayoutGroup(("moe",), 3),))


def run_child(body: str, src: Path, timeout_s: float = 300.0, args=()) -> dict:
    """Run ``PRELUDE + body`` against the package under ``src`` in a fresh
    process (``args`` its ``sys.argv[1:]``); its last line of output, as
    JSON."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((str(src), str(Path(__file__).parent))),
               MALLOC_MMAP_THRESHOLD_=str(2**20))
    out = subprocess.run([sys.executable, "-c", PRELUDE + body, *args], env=env,
                         capture_output=True, text=True, timeout=timeout_s, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def write_inflated_checkpoint(path, seed: int = 0) -> None:
    """A params-only checkpoint of the inflated config, random N(0, 0.02)
    fp32 leaves, written one leaf at a time (``save_checkpoint`` packs the
    whole payload in memory first): the same bytes as ``save_checkpoint``
    of a tree of those leaves."""
    import torch

    from repro_torch.models.model import init_params
    from repro_torch.recovery.msgpack_lite import _ARR, _len_header, packb
    from repro_torch.recovery.serial import array_record
    from repro_torch.training.checkpoint import tree_leaves, treedef_str

    shapes = init_params(inflated_config(), generator=torch.Generator(),
                         dtype=torch.float32, device="meta")
    leaves = tree_leaves(shapes)
    head = packb({"step": 0, "metadata": {}, "treedef": treedef_str(shapes), "leaves": []})
    assert head[-1:] == b"\x90"  # the empty leaves array, last
    gen = torch.Generator().manual_seed(seed)
    with open(path, "wb") as f:
        f.write(head[:-1] + _len_header(len(leaves), 0x90, 15, _ARR))
        for leaf in leaves:
            f.write(packb(array_record(torch.randn(leaf.shape, generator=gen) * 0.02)))
