#!/usr/bin/env python3
"""K2's worm instance and K5 on lane groups of 8, 16 or 32 lanes against
the one-thread kernels of a base tree, on one card in one call.

    python3 scripts/torch_group_variants.py --base DIR [--variants LIST] [--out DIR]

``DIR`` (``--base``) holds an unpacked tree of the commit to compare with
(``git archive <commit> nimblephysics_tpu_torch/csrc | tar -x -C DIR``);
its ``nimblephysics_tpu_torch/csrc`` is built as it is ("base"). This
tree's sources are built as they are ("as_built": K2 on groups of
``kK2Group``, K5 of ``kK5Group``, csrc/frozen_group.cuh) and, for each of
"g32", "g16" and "g8", with both set to 32, 16 or 8; ``--variants`` picks
some of these (comma-separated; by default all). All ``nvcc`` calls run at
once, into ``--out`` (by default the gitignored
``nimblephysics_tpu_torch/_build/group_variants/``). It prints each build's
time and ptxas's registers, stack and spills for the worm's K2 and K5
kernels, then, in f32 and f64 at the worm path's shapes (chip_smoke.py's
worm inputs, B=2048, T=100, PCG depth 12):

  * each library's K2 (worm), K5, K9 and K8 against the plain versions
    (largest relative error; chip_smoke.py holds the kept build to its
    rules), and their times (CUDA events, the libraries in turns forth and
    back, 3 calls each); K2 and K5 also at PCG depth 1, which shows the
    PCG's share of their time;
  * in f32, each library's warm worm replan (bench.py's row, warm from one
    cold replan of the first library after "base"), 3 calls each, in
    turns.

A base library's K5 takes a scratch buffer that this tree's wrapper does
not pass; the script hands it one. The last line is one JSON object with
every number; ``DIR/group_variants.json`` (``--out``) has the same.
"""

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nimblephysics_tpu_torch.ops import _build  # noqa: E402
from torch_unroll_variants import ptxas_table  # noqa: E402

OUT = _build.BUILD_ROOT / "group_variants"
GROUP_LINE = re.compile(r"constexpr int kK2Group = \d+, kK5Group = \d+, ")
# name -> the lanes per group of both K2 and K5 (0: as the sources are)
VARIANTS = {"as_built": 0, "g32": 32, "g16": 16, "g8": 8}
# the worm's K2 and K5 kernels in ptxas's output
ENTRIES = ("rollout_kernel", "rollout_group_kernel", "linearize_vjp")
REPS = 3


def transform(name: str, text: str, file: str) -> str:
    """The source of one variant (VARIANTS)."""
    group = VARIANTS[name]
    if group and file == "frozen_group.cuh":
        if not GROUP_LINE.search(text):
            raise RuntimeError("frozen_group.cuh no longer declares its group sizes as expected")
        text = GROUP_LINE.sub(f"constexpr int kK2Group = {group}, kK5Group = {group}, ", text)
    return text


def build(name: str, csrc: Path):
    """(library, seconds, nvcc's output) of one nvcc call on csrc's .cu
    files, transformed for a variant other than "base"."""
    src = OUT / name / "src"
    src.mkdir(parents=True, exist_ok=True)
    for p in csrc.iterdir():
        if p.suffix in (".cu", ".cuh"):
            text = p.read_text()
            if name != "base":
                text = transform(name, text, p.name)
            (src / p.name).write_text(text)
    lib = OUT / name / _build.LIB_NAME
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           *sorted(str(p) for p in src.iterdir() if p.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-4000:]}")
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


class BaseLib:
    """A base library behind this tree's launcher signatures: its K5 takes
    a scratch buffer ((2 + nq) m values per point) after the class masks."""

    def __init__(self, lib):
        self.lib = lib
        self.scratch = None

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def nptt_linearize_vjp(self, is_double, nb, nq, na, m, ns, n_points, n_cg, *ptrs):
        dtype = torch.float64 if is_double else torch.float32
        self.scratch = torch.empty((n_points, (2 + nq) * m), dtype=dtype, device="cuda")
        P, I, xs, u, cm, ucl, fx, fu, stream = ptrs
        return self.lib.nptt_linearize_vjp(is_double, nb, nq, na, m, ns, n_points, n_cg, P, I,
                                           xs, u, cm, ucl, self.scratch.data_ptr(), fx, fu,
                                           stream)


def load(name: str, path: Path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES.items():
        if name == "base" and fn == "nptt_linearize_vjp":
            argtypes = argtypes[:14] + [ctypes.c_void_p] + argtypes[14:]
        if name == "base" and fn.endswith("_group_shape"):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return BaseLib(lib) if name == "base" else lib


def flat(o):
    if isinstance(o, torch.Tensor):
        return [o] if o.dtype.is_floating_point else []
    return [t for x in o for t in flat(x)]


def rel_error(out_k, out_p) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(flat(out_k), flat(out_p)))


def kernel_calls(dev, dtype):
    """name -> (kernel call, plain call) on chip_smoke.py's worm inputs at
    the path's shapes."""
    inputs = cs.worm_kernel_inputs(dev, cs.WORM_B, cs.H, dtype)
    a2, k2 = inputs["rollout_gains[worm]"]
    a5, _ = inputs["linearize_vjp"]
    model, pre, u, classes, cg = a5
    rc, _ = cs.worm_costs(model)
    a9, k9 = (model, rc, pre[:, 0].contiguous(), u, classes), {"cg_iters": cg}
    k2_1, a5_1 = dict(k2, cg_iters=1), a5[:4] + (1,)
    return {
        "rollout_gains[worm]": (lambda: cs.rollout_gains(*a2, **k2),
                                lambda: cs.rollout_gains_plain(*a2, **k2)),
        "rollout_gains[worm] PCG depth 1": (lambda: cs.rollout_gains(*a2, **k2_1),
                                            lambda: cs.rollout_gains_plain(*a2, **k2_1)),
        "linearize_vjp PCG depth 1": (lambda: cs.linearize_vjp(*a5_1),
                                      lambda: cs.linearize_vjp_plain(*a5_1)),
        "linearize_vjp": (lambda: cs.linearize_vjp(*a5), lambda: cs.linearize_vjp_plain(*a5)),
        "chained_step_rollout": (lambda: cs.chained_step_rollout(*a9, **k9),
                                 lambda: cs.chained_step_rollout_plain(*a9, **k9)),
        "chained_linearize_vjp": (lambda: cs.chained_linearize_vjp(*a5[:4], cg_iters=cg),
                                  lambda: cs.chained_linearize_vjp_plain(*a5[:4], cg)),
    }


def main() -> int:
    global OUT
    args = sys.argv[1:]
    if "--base" not in args:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(args[args.index("--base") + 1]).resolve() / "nimblephysics_tpu_torch" / "csrc"
    if "--out" in args:
        OUT = Path(args[args.index("--out") + 1]).resolve()
    chosen = (args[args.index("--variants") + 1].split(",") if "--variants" in args
              else list(VARIANTS))
    if not set(chosen) <= set(VARIANTS):
        print(f"--variants: choose among {list(VARIANTS)}", file=sys.stderr)
        return 2
    libs_named = ("base",) + tuple(chosen)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    jobs = {n: base if n == "base" else _build.CSRC_DIR for n in libs_named}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda n: build(n, jobs[n]), jobs)))
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    libs = {}
    base_table = ptxas_table(built["base"][2])
    for name, (path, seconds, log) in built.items():
        full = ptxas_table(log)
        table = {e: r for e, r in full.items() if any(k in e for k in ENTRIES)
                 and "Li3ELi4ELi2ELi28ELi8E" in e}
        # every other kernel should compile as in the base tree
        others = [e for e in full if e in base_table and e not in table]
        differ = [e for e in others if full[e] != base_table[e]]
        result[name] = {"build_s": seconds, "ptxas": table,
                        "ptxas_other_kernels_differ_from_base": {e: [base_table[e], full[e]]
                                                                 for e in differ}}
        print(f"{name}: one nvcc call, {seconds:.1f} s ({len(jobs)} builds at a time); "
              f"{len(others) - len(differ)} of the other {len(others)} kernels compile with "
              f"the base's registers and stack", flush=True)
        for entry, row in sorted(table.items()):
            print(f"  {row}  {entry[:100]}", flush=True)
        for entry in differ:
            print(f"  differs from base: {base_table[entry]} -> {full[entry]}  {entry[:90]}",
                  flush=True)
        libs[name] = load(name, path)

    def use(name):
        _build.load = lambda: libs[name]

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        calls = kernel_calls(dev, dtype)
        for kname, (kern, plain) in calls.items():
            want = plain()
            times = {n: [] for n in libs_named}
            for n in libs_named:
                use(n)
                got = kern()
                torch.cuda.synchronize()
                result[n].setdefault("max_rel_err", {})[f"{kname} {dname}"] = rel_error(got, want)
            for n in libs_named + libs_named[::-1]:
                use(n)
                times[n].append(cs.time_ms(kern, REPS))
            for n in libs_named:
                result[n].setdefault("ms", {})[f"{kname} {dname}"] = times[n]
            errs = {n: result[n]["max_rel_err"][f"{kname} {dname}"] for n in libs_named}
            print(f"  {kname:22s} {dname}: " + "; ".join(
                f"{n} {times[n][0]:.4f}/{times[n][1]:.4f} ms (rel err {errs[n]:.2e})"
                for n in libs_named), flush=True)
        del calls
    print(f"[{time.perf_counter() - t0:.1f} s] the warm worm replan, f32, B={cs.WORM_B}",
          flush=True)
    x0 = cs.worm_x0(cs.WORM_B)
    use(libs_named[1])
    sol, cl, _ = cs.worm_solve(dev, torch.float32, True, x0)
    warm = (sol.u, cl)
    rates = {n: [] for n in libs_named}
    for n in libs_named + libs_named[::-1]:
        use(n)
        secs = [cs.worm_solve(dev, torch.float32, True, x0, classes=warm[1], u0=warm[0])[2]
                for _ in range(REPS)]
        rates[n].append(cs.WORM_B / (sum(secs) / len(secs)))
    for n in libs_named:
        result[n]["worm_replan_solves_per_s"] = rates[n]
    print("  warm worm replan (solves/s, forth/back): " + "; ".join(
        f"{n} {rates[n][0]:.1f}/{rates[n][1]:.1f}" for n in libs_named), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "group_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
