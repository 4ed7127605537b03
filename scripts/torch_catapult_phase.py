#!/usr/bin/env python3
"""chip_smoke.py's phase 16 (the catapult) alone.

    python3 scripts/torch_catapult_phase.py         # on one CUDA card, ~5 min
    python3 scripts/torch_catapult_phase.py --cpu   # rehearsal, ~70 s

On the card: the full build (phase 2), then phase_catapult as chip_smoke.py
runs it. With --cpu: the same calls on the plain versions at B = 8 (the
f64 checks at B = 4), T = 6, hyper at 30 sweeps, 100 steps of states
(STEPS in the environment changes that), with K7 alone (16a) left out and
the launch checks printed but not held (the plain path counts no launch).
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nimblephysics_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    if "--cpu" in sys.argv:
        dev, smi = torch.device("cpu"), "cpu rehearsal"
        cs.CAT_B, cs.CAT_B_CHECK, cs.CAT_T = 8, 4, 6
        cs.CAT_STEPS = int(os.environ.get("STEPS", "100"))
        cs.CAT_HYPER_SWEEPS = 30
        cs.phase_catapult_k7 = lambda dev, records, work: None
        cs.check_oracle_launches = lambda label, got, expected: cs.log(
            f"  (not held on the CPU) K7 {label}: {got}, expected {expected}")
    else:
        if not torch.cuda.is_available():
            print("torch_catapult_phase: CUDA is not available", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        _, secs = _build.build()
        _build.load()
        print(f"build {secs:.1f} s")
    records, work = {}, {}
    t1 = time.perf_counter()
    counts, times = cs.phase_catapult(dev, smi, records, work)
    print(f"phase 16 {time.perf_counter() - t1:.1f} s (all {time.perf_counter() - t0:.1f} s)")
    print(counts, times, records, work, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
