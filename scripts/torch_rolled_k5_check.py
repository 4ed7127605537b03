#!/usr/bin/env python3
"""Undefined behaviour in the device step's loops, checked on the host.

    python3 scripts/torch_rolled_k5_check.py --host   # no card needed, g++

``csrc/step.cuh`` rolls its loops over the LCP rows, the contact slots and
the PCG iterations, and K5 reads and writes the arrays of those loops by
run-time indices. A card has no device-side sanitizer
(``compute-sanitizer`` answers "Device not supported" on the H100), so this
script builds tests/test_torch_device_step.py's worm harness
(device_step, frozen_step, the lane-group bodies of K2, K4 and K5 on one
host thread per lane, K7's thread and group bodies, all on f64) three ways
with g++ (-O1
under -fsanitize=address,undefined; -O2 with every local variable filled
with a pattern, and with zeros, at creation),
runs each on the tests' worm points (PCG depths 12, 1 and 2) and on
chip_smoke.py's worm inputs (B=16, T=100, f64, the CPU), and prints the
sanitizers' verdict, whether the two fills give identical bits (a read of
an uninitialised variable that reaches a result would part them) and K5's
and K4's largest rel errors against their plain versions. scripts/torch_unroll_variants.py
checks the rolled kernels on the card.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nimblephysics_tpu_torch.ops import _build  # noqa: E402

HOST_VARIANTS = {
    "asan_ubsan": ("-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
                   "-fno-sanitize-recover=all"),
    "fill_pattern": ("-O2", "-ftrivial-auto-var-init=pattern"),
    "fill_zero": ("-O2", "-ftrivial-auto-var-init=zero"),
}
HOST_B = 16


def host_input(model, x, u, cm, us, n_cg) -> str:
    """The worm harness's input for these points (K7's part left out)."""
    import numpy as np

    from nimblephysics_tpu_torch.ops import device_step

    P, I = device_step.pack_model(model)
    n = x.shape[0]
    head = (model.num_bodies, model.nq, model.num_actions, cm.shape[-1],
            device_step.total_slots(model), n, P.numel(), I.numel(), n_cg)
    pts = np.concatenate([np.asarray(a, dtype=np.float64) for a in (x, u, cm, us)], axis=1)
    return "\n".join([" ".join(str(v) for v in head), " ".join(repr(v) for v in P.tolist()),
                      " ".join(str(v) for v in I.tolist()),
                      " ".join("0.0" for _ in range(8 * model.nq + model.num_actions)),
                      " ".join(repr(float(v)) for v in pts.ravel())])


def host() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    import test_torch_device_step as tds
    from nimblephysics_tpu_torch.ops.cuda_linearize import (
        linearize_split_plain,
        linearize_vjp_plain,
    )

    work = _build.BUILD_ROOT / "host_ub"
    work.mkdir(parents=True, exist_ok=True)
    (work / "worm_main.cpp").write_text(tds.WORM_MAIN)
    procs = {k: subprocess.Popen(["g++", "-std=c++17", "-pthread", *flags, "-I",
                                  str(_build.CSRC_DIR), str(work / "worm_main.cpp"), "-o",
                                  str(work / k)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, flags in HOST_VARIANTS.items()}
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            print(f"g++ {k} failed:\n{out[-3000:]}")
            return 1
    cases = {}
    for n_cg, sliding in tds.WORM_CASES:
        model, x, u, cm, us = tds.worm_points(sliding)
        cases[f"tests' worm points, depth {n_cg}, sliding {sliding}"] = (
            model, x, u, cm, us, n_cg)
    (model, pre, u, (cm, us), cg), _ = cs.worm_kernel_inputs(
        torch.device("cpu"), HOST_B, 100, torch.float64)["linearize_vjp"]
    flat = [t.reshape(-1, t.shape[-1]).numpy() for t in (pre, u, cm, us)]
    cases[f"chip_smoke.py's worm inputs, B={HOST_B}, T=100"] = (model, *flat, cg)
    results = {}
    for label, (model, x, u, cm, us, n_cg) in cases.items():
        text = host_input(model, x, u, cm, us, n_cg)
        n = x.shape[0]
        fx, fu = linearize_vjp_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                     (torch.tensor(cm)[:, None], torch.tensor(us)[:, None]),
                                     n_cg)
        ref = np.concatenate([fx.reshape(n, -1).numpy(), fu.reshape(n, -1).numpy()], axis=1)
        fx4, fu4 = linearize_split_plain(
            model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
            (torch.tensor(cm)[:, None], torch.tensor(us)[:, None]), n_cg)
        ref4 = np.concatenate([fx4.reshape(n, -1).numpy(), fu4.reshape(n, -1).numpy()], axis=1)
        rows = {}
        res = {"points": n, "upper_rows": int((np.asarray(us) != 0).sum())}
        for k in HOST_VARIANTS:
            p = subprocess.run([str(work / k)], input=text, capture_output=True, text=True)
            res[f"{k} rc"] = p.returncode
            if p.stderr.strip():
                res[f"{k} stderr"] = p.stderr[-1500:]
            rows[k] = np.array([[float(t) for t in line.split()]
                                for line in p.stdout.splitlines()[6:6 + n]])
            res[f"{k} nonfinite points"] = int((~np.isfinite(rows[k])).any(axis=1).sum())
        res["fills bit-identical"] = bool(np.array_equal(rows["fill_pattern"], rows["fill_zero"]))
        res["sanitized == fill_zero"] = bool(np.array_equal(rows["asan_ubsan"], rows["fill_zero"]))
        res["K5 max rel err vs plain"] = float(
            np.abs(rows["fill_zero"][:, 24:104] - ref).max() / np.abs(ref).max())
        res["K4 max rel err vs plain"] = float(
            np.abs(rows["fill_zero"][:, 104:184] - ref4).max() / np.abs(ref4).max())
        print(label, json.dumps(res), flush=True)
        results[label] = res
    ok = all(r[f"{k} rc"] == 0 and f"{k} stderr" not in r for r in results.values()
             for k in HOST_VARIANTS) and all(r["fills bit-identical"] for r in results.values())
    print(json.dumps({"clean": ok}))
    return 0 if ok else 1


def main() -> int:
    if sys.argv[1:] != ["--host"]:
        print(__doc__, file=sys.stderr)
        return 2
    return host()


if __name__ == "__main__":
    sys.exit(main())
