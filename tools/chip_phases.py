"""Some of chip_smoke's phases alone on the card, without the rest of the
run: the kernel library built, then, in this order, any of

* ``gmm``: the ``moe_gmm`` cases of Mixtral-8x7B's shapes, phase 23(e)'s
  included (``chip_smoke.mixtral_gmm_cases``), against their plain
  versions, beside ``torch.bmm`` and their bound;
* ``p11``: phase 4's batch served (full-width OLMoE-1B-7B, bf16, C = 16)
  for phase 11's inputs, then ``chip_smoke.predictor_phase`` (``serve
  --predictor``, the routing trace streamed from the store and held
  bit-equal to the whole tree's);
* ``p15``: with ``p11``, ``chip_smoke.serve_baselines`` (phase 15, on
  ``p11``'s Psi scores) then ``chip_smoke.little_phase`` (phase 16);
* ``wave``: ``chip_smoke.serve_wave`` (phase 8);
* ``p23``: ``chip_smoke.mixtral_phase`` (phase 23: Mixtral-8x7B offloaded,
  its children spawned; (e), the paper's comparison systems, inside them).

    python tools/chip_phases.py [gmm] [p11 [p15]] [wave] [p23] > phases.log 2>&1

(p11, wave and p23 without arguments). Run from the root of a checkout: the card's
name and power limit first, each phase's own rows and gates as
chip_smoke prints them, and the seconds of the whole. A failing gate
raises, as in chip_smoke.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(which) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import run

    t0 = time.perf_counter()
    _build.lib()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "gmm" in which:
        gen = torch.Generator(device="cuda")
        for seed, shapes in ((2, ((2, 4), (6, 512))), (3, cs.MIXTRAL_BASELINE_GMM_SHAPES)):
            for c in cs.mixtral_gmm_cases(gen.manual_seed(seed), shapes):
                print({k: c[k] for k in ("case", "route", "max_abs_err", "ms", "eager_ms",
                                         "plain_ms", "library_ms", "bound_ms", "bound_by")
                       if k in c}, f"fma_ms {c.get('fma_ms')}", flush=True)
    if "p11" in which:
        kw = dict(capacity=16, policy="gamma", batch=4, prompt_len=128, dtype=torch.bfloat16,
                  device="cuda", seed=0)
        rep = run("olmoe", max_new=32, **kw)
        main_stats = {k: rep[k] for k in ("transfers", "prefetch_transfers", "hit_rate",
                                          "modeled_time_s", "decode_tok_s", "prefill_s")}
        print("main olmoe", main_stats, flush=True)
        p_rep = cs.predictor_phase(rep["tokens"], main_stats, kw)
        if "p15" in which:
            t = time.perf_counter()
            _, shared = cs.serve_baselines(rep["tokens"], p_rep["psi_scores"])
            cs.little_phase(shared)
            del shared
            print(f"phases 15-16 {time.perf_counter() - t:.1f} s", flush=True)
        del rep
    if "wave" in which:
        cs.serve_wave()
    if "p23" in which:
        cs.mixtral_phase()
    print(f"ALL DONE {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":  # phase 23's children are spawned: they import this file
    main(sys.argv[1:] or ["p11", "wave", "p23"])
