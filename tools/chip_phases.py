"""Some of chip_smoke's phases alone on the card, without the rest of the
run: the kernel library built, then, in this order, any of

* ``gmm``: the ``moe_gmm`` cases of Mixtral-8x7B's shapes, phase 23(e)'s
  included (``chip_smoke.offload_gmm_cases``), against their plain
  versions, beside ``torch.bmm`` and their bound;
* ``phi``: the ``moe_gmm`` and ``int4_matmul`` cases of Phi-3.5-MoE's
  shapes (``offload_gmm_cases``, ``offload_int4_shapes``), as chip_smoke
  draws them, against their plain versions, beside their bound and the
  library call;
* ``p11``: phase 4's batch served (full-width OLMoE-1B-7B, bf16, C = 16)
  for phase 11's inputs, then ``chip_smoke.predictor_phase`` (``serve
  --predictor``, the routing trace streamed from the store and held
  bit-equal to the whole tree's);
* ``p15``: with ``p11``, ``chip_smoke.serve_baselines`` (phase 15, on
  ``p11``'s Psi scores) then ``chip_smoke.little_phase`` (phase 16);
* ``wave``: ``chip_smoke.serve_wave`` (phase 8);
* ``deepseek``: ``chip_smoke.serve_deepseek`` (phase 9: DeepSeek-MoE-16B
  offloaded, bf16 at full depth, its fp32 check);
* ``p20``: ``chip_smoke.dict_phase`` (phase 20, the per-expert engine); a
  checkout whose phase 20 takes phases 4 and 5's reports (``dict_phase(
  slab)``, before its bf16 and INT4 serves were cut in depth) gets them
  served first, outside the phase's seconds;
* ``p23``: ``chip_smoke.mixtral_phase`` (phase 23: Mixtral-8x7B offloaded,
  its children spawned; (e), the paper's comparison systems, inside them);
* ``p24``: ``chip_smoke.phi_phase`` (phase 24: Phi-3.5-MoE offloaded, INT4
  then bf16, its children spawned).

    python tools/chip_phases.py [gmm] [phi] [p11 [p15]] [wave] [deepseek] [p20] [p23] \
        [p24] > phases.log 2>&1

(p11, wave and p23 without arguments). Run from the root of a checkout: the card's
name and power limit first, each phase's own rows and gates as
chip_smoke prints them, and the seconds of the whole. A failing gate
raises, as in chip_smoke.
"""
import inspect
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
    keys = ("case", "route", "max_abs_err", "ms", "eager_ms", "plain_ms", "library_ms",
            "library_int4pack_ms", "bound_ms", "bound_by", "fma_ms")
    if "gmm" in which:
        gen = torch.Generator(device="cuda")
        for seed, shapes in ((2, None), (3, cs.MIXTRAL_BASELINE_GMM_SHAPES)):
            for c in cs.offload_gmm_cases(gen.manual_seed(seed), cs.MIXTRAL, shapes):
                print({k: c[k] for k in keys if k in c}, flush=True)
    if "phi" in which:
        gen = torch.Generator(device="cuda").manual_seed(4)  # chip_smoke's draws
        for c in (cs.offload_gmm_cases(gen, cs.PHI)
                  + cs.int4_cases(gen, cs.offload_int4_shapes(cs.PHI))):
            print({k: c[k] for k in keys if k in c}, flush=True)
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
    if "deepseek" in which:
        cs.serve_deepseek()
    if "p20" in which:
        if "slab" in inspect.signature(cs.dict_phase).parameters:
            kw = dict(capacity=16, policy="gamma", batch=4, prompt_len=128,
                      dtype=torch.bfloat16, device="cuda", seed=0)
            slab = {"slab-bf16": cs._slab_row(run("olmoe", max_new=32, **kw)),
                    "slab-int4": cs._slab_row(run("olmoe", max_new=32, quantized=True, **kw))}
            cs.dict_phase(slab)
        else:
            cs.dict_phase()
    if "p23" in which:
        cs.mixtral_phase()
    if "p24" in which:
        cs.phi_phase()
    print(f"ALL DONE {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":  # phase 23's children are spawned: they import this file
    main(sys.argv[1:] or ["p11", "wave", "p23"])
