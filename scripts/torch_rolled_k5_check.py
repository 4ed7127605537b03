#!/usr/bin/env python3
"""Does K5 stay right when the device step's loops are rolled?

    python3 scripts/torch_rolled_k5_check.py        # on one CUDA card

The port's ``csrc/step.cuh`` unrolls every loop over the LCP rows, which
makes ``linearize.cu`` take minutes to compile. This script copies
``common.cuh``, ``step.cuh`` and ``linearize.cu`` into the gitignored
``_build/rolled_src/``, turns every ``#pragma unroll`` there into
``#pragma unroll 1`` (every loop rolled), and builds that copy in child
processes, all started together, once per variant:

  rolled_O3   the package's own nvcc flags (-O3);
  rolled_G    device debug code (-G: no optimisation by NVVM or ptxas).

Each child runs K5 (``linearize_vjp``) from its library on the jump worm's
own inputs (chip_smoke.py's worm_kernel_inputs at B=8, T=100, f64 and f32)
and prints the points whose (fx, fu) is not finite and the largest
relative error against the plain version. Then, where the toolkit has
``compute-sanitizer``, the rolled_O3 child runs again under its initcheck
and memcheck tools, both together (the library is built by then), and
their last lines are printed. The last line is one JSON object with every result.

    python3 scripts/torch_rolled_k5_check.py --host   # no card needed, g++

checks the same source for undefined behaviour on the host instead: it
builds tests/test_torch_device_step.py's worm harness (device_step,
frozen_step, K5's two thread bodies, K2's and K7's, all on f64) three ways
with g++ (-O1 under -fsanitize=address,undefined; -O2 with every local
variable filled with a pattern, and with zeros, at creation), runs each on
the tests' worm points (PCG depths 12, 1 and 2) and on chip_smoke.py's
worm inputs (B=16, T=100, f64, the CPU), and prints the sanitizers'
verdict, whether the two fills give identical bits (a read of an
uninitialised variable that reaches a result would part them) and K5's
largest rel error against its plain version.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nimblephysics_tpu_torch.ops import _build  # noqa: E402

ROLLED = _build.BUILD_ROOT / "rolled_src"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
VARIANTS = {
    "rolled_O3": _build.NVCC_FLAGS,
    "rolled_G": GENCODE + ("-G", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"),
}
ROLLED_FILES = ("common.cuh", "step.cuh", "linearize.cu")
B, T = 8, 100
CHILD_TIMEOUT_S = 420
SANITIZER_TIMEOUT_S = 300


def write_rolled() -> int:
    """The rolled copy of the sources; returns the number of pragmas changed."""
    ROLLED.mkdir(parents=True, exist_ok=True)
    changed = 0
    for name in ROLLED_FILES:
        text = (_build.CSRC_DIR / name).read_text()
        text, n = re.subn(r"^(\s*)#pragma unroll\s*$", r"\1#pragma unroll 1", text,
                          flags=re.MULTILINE)
        changed += n
        (ROLLED / name).write_text(text)
    return changed


def child(variant: str) -> int:
    """Build (or find) the variant's library, run K5 from it, print one JSON line."""
    import torch

    import chip_smoke as cs
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_vjp, linearize_vjp_plain

    _build.CSRC_DIR = ROLLED
    _build.BUILD_ROOT = ROLLED.parent / f"rolled_{variant}"
    _build.NVCC_FLAGS = VARIANTS[variant]
    path, seconds = _build.build()
    lib = ctypes.CDLL(str(path))
    fn = lib.nptt_linearize_vjp
    fn.argtypes = _build.SIGNATURES["nptt_linearize_vjp"]
    fn.restype = ctypes.c_int
    _build.load = lambda: lib  # the wrapper launches from this variant's library
    stack = [line.strip() for line in _build.build_log().splitlines()
             if "linearize_vjp" in line or ("stack frame" in line)]
    out = {"variant": variant, "build_s": round(seconds, 1), "ptxas": stack[-8:]}
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    for dtype in (torch.float64, torch.float32):
        # the inputs and the plain version on the CPU, so that only K5 runs
        # on the card (under compute-sanitizer too)
        (model, pre, u, classes, cg), _ = cs.worm_kernel_inputs(cpu, B, T, dtype)["linearize_vjp"]
        fx, fu = linearize_vjp(cs.worm_model(dev, dtype), pre.to(dev), u.to(dev),
                               tuple(c.to(dev) for c in classes), cg)
        fx, fu = fx.cpu(), fu.cpu()
        fxp, fup = linearize_vjp_plain(model, pre, u, classes, cg)
        k = torch.cat([fx.flatten(2), fu.flatten(2)], -1)
        p = torch.cat([fxp.flatten(2), fup.flatten(2)], -1)
        bad = int((~torch.isfinite(k).all(-1)).sum())
        rel = float(((k - p).abs().max() / p.abs().max().clamp_min(1e-300))
                    .nan_to_num(float("inf")))
        out[str(dtype).split(".")[-1]] = {"points": B * T, "nonfinite_points": bad,
                                          "max_rel_err": rel}
    print(json.dumps(out), flush=True)
    return 0


def sanitizer() -> str:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "compute-sanitizer"
    return str(cand) if cand.exists() else ""


def run(cmd, timeout):
    """(exit code or 'timeout', the output's last lines)."""
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
        return p.returncode, (p.stdout + p.stderr)[-3000:]
    except subprocess.TimeoutExpired as e:
        text = "".join((b or b"").decode(errors="replace") for b in (e.stdout, e.stderr))
        return "timeout", text[-3000:]


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
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_vjp_plain

    work = _build.BUILD_ROOT / "host_ub"
    work.mkdir(parents=True, exist_ok=True)
    (work / "worm_main.cpp").write_text(tds.WORM_MAIN)
    procs = {k: subprocess.Popen(["g++", "-std=c++17", *flags, "-I", str(_build.CSRC_DIR),
                                  str(work / "worm_main.cpp"), "-o", str(work / k)],
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
        rows = {}
        res = {"points": n, "upper_rows": int((np.asarray(us) != 0).sum())}
        for k in HOST_VARIANTS:
            p = subprocess.run([str(work / k)], input=text, capture_output=True, text=True)
            res[f"{k} rc"] = p.returncode
            if p.stderr.strip():
                res[f"{k} stderr"] = p.stderr[-1500:]
            rows[k] = np.array([[float(t) for t in line.split()]
                                for line in p.stdout.splitlines()[4:4 + n]])
            res[f"{k} nonfinite points"] = int((~np.isfinite(rows[k])).any(axis=1).sum())
        res["fills bit-identical"] = bool(np.array_equal(rows["fill_pattern"], rows["fill_zero"]))
        res["sanitized == fill_zero"] = bool(np.array_equal(rows["asan_ubsan"], rows["fill_zero"]))
        res["K5 max rel err vs plain"] = float(
            np.abs(rows["fill_zero"][:, 16:96] - ref).max() / np.abs(ref).max())
        print(label, json.dumps(res), flush=True)
        results[label] = res
    ok = all(r[f"{k} rc"] == 0 and f"{k} stderr" not in r for r in results.values()
             for k in HOST_VARIANTS) and all(r["fills bit-identical"] for r in results.values())
    print(json.dumps({"clean": ok}))
    return 0 if ok else 1


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    if sys.argv[1:] == ["--host"]:
        return host()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(f"{write_rolled()} pragmas rolled", flush=True)
    me = str(Path(__file__).resolve())
    procs = {v: subprocess.Popen([sys.executable, me, "--child", v], cwd=ROOT,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v in VARIANTS}
    results = {}
    for v, p in procs.items():
        try:
            text, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += "\ntimed out"
        print(f"--- {v} (rc {p.returncode}, {time.perf_counter() - t0:.1f} s)\n{text[-3000:]}",
              flush=True)
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        results[v] = json.loads(lines[-1]) if lines else {"rc": p.returncode}
    cs_bin = sanitizer()
    if not cs_bin:
        results["compute-sanitizer"] = "not in the toolkit"
    elif "rolled_O3" in results and "float64" in results["rolled_O3"]:
        tools = ("initcheck", "memcheck")
        with ThreadPoolExecutor(len(tools)) as pool:
            runs = pool.map(lambda tool: run([cs_bin, "--tool", tool, "--print-limit", "10",
                                              sys.executable, me, "--child", "rolled_O3"],
                                             SANITIZER_TIMEOUT_S), tools)
            for tool, (rc, tail) in zip(tools, runs):
                print(f"--- compute-sanitizer {tool} (rc {rc}, "
                      f"{time.perf_counter() - t0:.1f} s)\n{tail}", flush=True)
                summary = [ln for ln in tail.splitlines() if "ERROR SUMMARY" in ln]
                results[f"compute-sanitizer {tool}"] = {"rc": rc, "summary": summary[-1:] or
                                                        tail.splitlines()[-3:]}
    print(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
