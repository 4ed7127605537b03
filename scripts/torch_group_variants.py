#!/usr/bin/env python3
"""The worm's lane-group kernels at several group layouts against a base
tree's kernels, on one card in one call.

    python3 scripts/torch_group_variants.py --base DIR [--variants LIST] [--out DIR]
                                            [--kernels LIST] [--replans LIST]

``DIR`` (``--base``) holds an unpacked tree of the commit to compare with
(``git archive <commit> nimblephysics_tpu_torch/csrc | tar -x -C DIR``);
its ``nimblephysics_tpu_torch/csrc`` is built as it is ("base"). This
tree's sources are built as they are ("as_built") and in the variants of
VARIANTS, each of which sets some of the layout constants
(csrc/frozen_group.cuh: the lanes of K2's, K5's and K4's groups, kK2Group,
kK5Group, kK4Group, and K4's tangent right-hand sides per pass over Qf,
kK4Rhs; csrc/lcp.cu: K7's, kK7Group); ``--variants`` picks some of them
(comma-separated; by default all). All ``nvcc`` calls run at once, into
``--out`` (by default the gitignored
``nimblephysics_tpu_torch/_build/group_variants/``). It prints each build's
time and ptxas's registers, stack and spills for the worm's kernels and
K7, then, at the worm path's shapes (chip_smoke.py's worm inputs, B=2048,
T=100, PCG depth 12) in f32 and f64:

  * each library's kernels of KERNELS (``--kernels`` picks some) against
    the plain versions (largest relative error; chip_smoke.py holds the
    kept build to its rules), and their times (CUDA events, the libraries
    in turns forth and back, 3 calls each): K2 (worm), K5, K9 and K8, K2
    and K5 also at PCG depth 1 (the PCG's share of their time), K3 with
    classes= (K4's kernel at depth m + 6), K4 at depth 12 and K7;
  * in f32, each library's warm worm replans of REPLANS (``--replans``;
    ILQRConfig(linearize=...): "auto", bench.py's row, and "jvp", K3
    classes=; "split" and "chain" on request), warm from one cold replan of
    the first library after "base", 3 calls each, in turns.

The last line is one JSON object with every number, with the card's name
and power limit; ``DIR/group_variants.json`` (``--out``) has the same.
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
# each layout constant, the file that declares it and its declaration
CONSTANTS = {
    "kK2Group": ("frozen_group.cuh", r"kK2Group = \d+"),
    "kK5Group": ("frozen_group.cuh", r"kK5Group = \d+"),
    "kK4Group": ("frozen_group.cuh", r"kK4Group = \d+"),
    "kK4Rhs": ("frozen_group.cuh", r"kK4Rhs = \d+"),
    "kK7Group": ("lcp.cu", r"kK7Group = \d+"),
}
# name -> the constants it sets (the others as the sources have them)
VARIANTS = {
    "as_built": {},
    "g32": {"kK2Group": 32, "kK5Group": 32},
    "g16": {"kK2Group": 16, "kK5Group": 16},
    "g8": {"kK2Group": 8, "kK5Group": 8},
    "k4g32": {"kK4Group": 32, "kK4Rhs": 10},
    "k4g16x5": {"kK4Group": 16, "kK4Rhs": 2},
    "k4g8x2": {"kK4Group": 8, "kK4Rhs": 5},
    "k4g8x5": {"kK4Group": 8, "kK4Rhs": 2},
    "k7g16": {"kK7Group": 16},
}
# the worm's kernels (its shape in the mangled names) and K7's, in ptxas's output
WORM_SHAPE = "Li3ELi4ELi2ELi28ELi8E"
ENTRIES = ("rollout_kernel", "rollout_group_kernel", "linearize_vjp", "linearize_split_kernel",
           "linearize_jvp_group", "pgs_kernel", "pgs_group")
KERNELS = ("rollout_gains[worm]", "rollout_gains[worm] PCG depth 1", "linearize_vjp PCG depth 1",
           "linearize_vjp", "chained_step_rollout", "chained_linearize_vjp", "linearize[classes]",
           "linearize_split[worm]", "pgs_batched")
REPLANS = ("auto", "jvp", "split", "chain")
REPS = 3


def transform(name: str, text: str, file: str) -> str:
    """The source of one variant (VARIANTS)."""
    for const, value in VARIANTS[name].items():
        where, pattern = CONSTANTS[const]
        if file != where:
            continue
        if not re.search(pattern, text):
            raise RuntimeError(f"{file} no longer declares {const} as expected")
        text = re.sub(pattern, f"{const} = {value}", text)
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


def load(path: Path):
    """A library behind this tree's launcher signatures; a launcher a base
    library lacks (a layout query added since) stays unset."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES.items():
        try:
            f = getattr(lib, fn)
        except AttributeError:
            continue
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def flat(o):
    if isinstance(o, torch.Tensor):
        return [o] if o.dtype.is_floating_point else []
    return [t for x in o for t in flat(x)]


def rel_error(out_k, out_p) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(flat(out_k), flat(out_p)))


def kernel_calls(dev, dtype, chosen):
    """name -> (kernel call, plain call) on chip_smoke.py's worm inputs at
    the path's shapes, for the names in ``chosen``."""
    inputs = cs.worm_kernel_inputs(dev, cs.WORM_B, cs.H, dtype)
    a2, k2 = inputs["rollout_gains[worm]"]
    a5, _ = inputs["linearize_vjp"]
    a7, _ = inputs["pgs_batched"]
    model, pre, u, classes, cg = a5
    rc, _ = cs.worm_costs(model)
    a9, k9 = (model, rc, pre[:, 0].contiguous(), u, classes), {"cg_iters": cg}
    k2_1, a5_1 = dict(k2, cg_iters=1), a5[:4] + (1,)
    calls = {
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
        "linearize[classes]": (lambda: cs.linearize_classes(*a5[:4]),
                               lambda: cs.linearize_classes_plain(*a5[:4])),
        "linearize_split[worm]": (lambda: cs.linearize_split(*a5),
                                  lambda: cs.linearize_split_plain(*a5)),
        "pgs_batched": (lambda: cs.pgs_batched(*a7), lambda: cs.pgs_batched_plain(*a7)),
    }
    return {k: v for k, v in calls.items() if k in chosen}


def arg_list(args, flag, default, allowed):
    chosen = args[args.index(flag) + 1].split(",") if flag in args else list(default)
    if not set(chosen) <= set(allowed):
        raise SystemExit(f"{flag}: choose among {list(allowed)}")
    return chosen


def main() -> int:
    global OUT
    args = sys.argv[1:]
    if "--base" not in args:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(args[args.index("--base") + 1]).resolve() / "nimblephysics_tpu_torch" / "csrc"
    if "--out" in args:
        OUT = Path(args[args.index("--out") + 1]).resolve()
    chosen = arg_list(args, "--variants", VARIANTS, VARIANTS)
    kernels = arg_list(args, "--kernels", KERNELS, KERNELS)
    replans = arg_list(args, "--replans", ("auto", "jvp"), REPLANS)
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
                 and (WORM_SHAPE in e or "pgs" in e)}
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
        libs[name] = load(path)

    def use(name):
        _build.load = lambda: libs[name]

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        calls = kernel_calls(dev, dtype, kernels)
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
    x0 = cs.worm_x0(cs.WORM_B)
    for lin in replans:
        print(f"[{time.perf_counter() - t0:.1f} s] the warm worm replan, "
              f"linearize={lin!r}, f32, B={cs.WORM_B}", flush=True)
        use(libs_named[1])
        sol, cl, _ = cs.worm_solve(dev, torch.float32, True, x0, lin=lin)
        warm = (sol.u, cl)
        rates = {n: [] for n in libs_named}
        for n in libs_named + libs_named[::-1]:
            use(n)
            secs = [cs.worm_solve(dev, torch.float32, True, x0, classes=warm[1], u0=warm[0],
                                  lin=lin)[2] for _ in range(REPS)]
            rates[n].append(cs.WORM_B / (sum(secs) / len(secs)))
        key = "worm_replan_solves_per_s" + ("" if lin == "auto" else f" {lin}")
        for n in libs_named:
            result[n][key] = rates[n]
        print(f"  warm worm replan {lin!r} (solves/s, forth/back): " + "; ".join(
            f"{n} {rates[n][0]:.1f}/{rates[n][1]:.1f}" for n in libs_named), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "group_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
