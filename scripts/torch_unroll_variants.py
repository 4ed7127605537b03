#!/usr/bin/env python3
"""Which loops of the device step pay for being unrolled?

    python3 scripts/torch_unroll_variants.py [--out DIR]   # on one CUDA card

The loops over bodies, dofs, actions and 3- or 6-vectors unroll by
``unroll_by(StepLayout::kUnroll, trips)`` (fully for models of up to 2
bodies and 2 dofs, the cartpole; rolled for larger ones, the jump worm),
the loops over the LCP rows and slots by ``row_unroll(M, trips)`` (fully up
to 8 rows, the limited cartpole; at the worm's 28 rolled, but for the dot
products over the rows, unrolled by 8), the PCG's iterations never;
``riccati.cu`` and K7's ``lcp.cu`` always unroll. This script builds these
libraries of the kernels, each with one ``nvcc`` call, 8 at a time (copies
of the sources go to ``DIR``, by default the gitignored
``_build/variants/``):

  as_built        the sources as they are;
  all_rolled      every unrolled loop of every source rolled
                  (``#pragma unroll 1``);
  small_unrolled  the body and dof loops under a plain ``#pragma unroll``
                  for every model (rows as built);
  dot_rolled      the dot products over the rows rolled at 28 rows;
  dot4, dot16     those dot products unrolled by 4 or by 16;

and, checked but not timed, the shape of an earlier build that gave a
wrong K5 on the card: the loops over a body's ancestors bounded by ``i``
(the outer body loop's index, so with a run-time trip count where the
outer loop is rolled) under a plain ``#pragma unroll``:

  fault           that shape, ``ap`` (forward_dynamics) left unset until a
                  parent writes it;
  fault_ptxas_O1  the same with ``-Xptxas -O1``;
  fault_ptxas_O0  the same with ``-Xptxas -O0``;
  fault_G         the same with ``-G`` (no device optimisation);
  fault_ap_init   the same with ``ap`` zeroed first;
  fault_fd, fault_mm, fault_cr
                  the shape in forward_dynamics, mass_matrix or the
                  contact rows (world_frames, slot_jacobian) only;
  fault_mm_pp, fault_mm_jj
                  the shape on mass_matrix's loop over pp, or over jj,
                  only.

It also compiles ``lcp.cu`` alone, as built and rolled (K7's build cost),
and dumps with ``cuobjdump`` the SASS of K5's f64 kernels of as_built,
fault and fault_ptxas_O1 (their instruction counts go to the JSON file).
It prints each build's time and ptxas's registers, stack and spills per
kernel; then, for each library, every kernel against its plain version in
f64 and f32 at small batches (chip_smoke.py's inputs; the worm's K2 over
one step, K4 and K5 also on chip_smoke.py's 256 sliding points at PCG
depths 1 and 2), the count of non-finite outputs (the fault's variants
last: a launch that fails ends their checks), and each kernel's time
at its path's full shapes in f32 for the timed libraries (CUDA events, the
libraries in turns, forth and back). The last line is one JSON
object with the build times and kernel times; ``DIR/unroll_variants.json``
has everything.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nimblephysics_tpu_torch.ops import _build  # noqa: E402

OUT = _build.BUILD_ROOT / "variants"
TIMED = ("as_built", "all_rolled", "small_unrolled", "dot_rolled", "dot4", "dot16")
FAULT = ("fault", "fault_ptxas_O1", "fault_ptxas_O0", "fault_ap_init", "fault_G",
         "fault_fd", "fault_mm", "fault_cr", "fault_mm_pp", "fault_mm_jj")
EXTRA_FLAGS = {"fault_ptxas_O1": ("-Xptxas", "-O1"), "fault_ptxas_O0": ("-Xptxas", "-O0"),
               "fault_G": ("-G",)}
# the fault's shape in one function only, on its loops of the given kinds
FAULT_IN = {"fault_fd": (("forward_dynamics_impl",), "pp jj"),
            "fault_mm": (("mass_matrix_impl",), "pp jj"),
            "fault_cr": (("world_frames", "slot_jacobian"), "pp jj"),
            "fault_mm_pp": (("mass_matrix_impl",), "pp"),
            "fault_mm_jj": (("mass_matrix_impl",), "jj")}
SASS = ("as_built", "fault", "fault_ptxas_O1")
B_SMALL = 64
AP_INIT = "    for (int k = 0; k < 6; ++k) ap[k] = S(T(0));\n"


def with_fault_shape(text: str, loops: str = "pp jj") -> str:
    """The ancestor loops (over pp, over jj) bounded by i under a plain
    #pragma unroll, as in the build that gave a wrong K5."""
    if "pp" in loops:
        text = re.sub(r"(?:#pragma unroll \(unroll_by\((?:L::kUnroll|UR), NB\)\)|"
                      r"NPTT_UNROLL\((?:L::kUnroll|UR), NB\))\n(\s*)"
                      r"for \(int pp = 0; pp < NB; \+\+pp\)",
                      r"#pragma unroll\n\1for (int pp = 0; pp < i; ++pp)", text)
        text = text.replace("pp < i && pp == par", "pp == par").replace(
            "pp >= i || pp != par", "pp != par")
    if "jj" in loops:
        text = re.sub(r"(?:#pragma unroll \(unroll_by\((?:L::kUnroll|UR), NB - 1\)\)|"
                      r"NPTT_UNROLL\((?:L::kUnroll|UR), NB - 1\))\n(\s*)"
                      r"for \(int jj = NB - 1; jj >= 1; --jj\)",
                      r"#pragma unroll\n\1for (int jj = i; jj >= 1; --jj)", text)
    return text


def in_function(text: str, name: str, fn) -> str:
    """fn applied to the body of the function ``name`` only."""
    start = text.find(f"void {name}(")
    if start < 0:
        return text
    end = text.index("\n}\n", start)
    return text[:start] + fn(text[start:end]) + text[end:]


def transform(variant: str, text: str) -> str:
    # step.cuh's loops carry NPTT_UNROLL(full, trips) (common.cuh), the
    # others #pragma unroll (unroll_by(full, trips))
    if variant == "all_rolled":
        return re.sub(r"^(?:#pragma unroll( \(.*\))?|NPTT_UNROLL\(.*\))$", "#pragma unroll 1", text,
                      flags=re.MULTILINE)
    if variant == "small_unrolled":
        return re.sub(r"^(?:#pragma unroll \(unroll_by\(.*\)\)|NPTT_UNROLL\(.*\))$",
                      "#pragma unroll", text, flags=re.MULTILINE)
    if variant == "dot_rolled":
        return text.replace("row_unroll(M, M - 1, 8)", "row_unroll(M, M - 1)")
    if variant in ("dot4", "dot16"):
        return text.replace("row_unroll(M, M - 1, 8)", f"row_unroll(M, M - 1, {variant[3:]})")
    if variant in FAULT_IN:
        names, loops = FAULT_IN[variant]
        for name in names:
            text = in_function(text, name, lambda t: with_fault_shape(t, loops))
        return text
    if variant.startswith("fault"):
        text = with_fault_shape(text)
        return text if variant == "fault_ap_init" else text.replace(AP_INIT, "")
    return text


def sources(variant: str) -> Path:
    dst = OUT / variant / "src"
    dst.mkdir(parents=True, exist_ok=True)
    for p in _build.sources():
        (dst / p.name).write_text(transform(variant, p.read_text()))
    return dst


def build(variant: str):
    """(library path, seconds, nvcc's output) of one nvcc call."""
    src = sources(variant)
    out = OUT / variant
    lib = out / _build.LIB_NAME
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *EXTRA_FLAGS.get(variant, ()), "-shared", "-o",
           str(lib), *sorted(str(p) for p in src.iterdir() if p.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{variant}: nvcc failed\n{proc.stderr[-4000:]}")
    return lib, seconds, proc.stdout + proc.stderr


def build_lcp_alone(variant: str) -> float:
    """Seconds of one nvcc call that compiles lcp.cu alone to an object."""
    src = OUT / variant / "src" / "lcp.cu"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(OUT / variant / "lcp_alone.o"),
           str(src)]
    t0 = time.perf_counter()
    subprocess.run(cmd, capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S, check=True)
    return time.perf_counter() - t0


def sass_counts(variant: str) -> dict:
    """Instruction counts of K5's f64 kernels (their SASS is kept beside the
    library)."""
    lib = OUT / variant / _build.LIB_NAME
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=600, check=True).stdout
    counts, keep, name = {}, [], None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "linearize_vjp" in m.group(1) and "Id" in m.group(1) else None
            if name:
                counts[name] = 0
        if name:
            keep.append(line)
            if re.search(r"/\*[0-9a-f]{4,}\*/", line):
                counts[name] += 1
    (OUT / variant / "k5_f64.sass").write_text("\n".join(keep))
    return counts


def ptxas_table(log: str) -> dict:
    """Per kernel entry (demangled name shortened): registers, stack bytes,
    spill stores and loads."""
    rows, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        # the first such line after the entry is the entry's (f64 entries
        # add one for a math library function after it)
        if m and "stack" not in rows.get(entry, {}):
            rows.setdefault(entry, {}).update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                                              spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(entry, {})["regs"] = int(m.group(1))
    return rows


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def calls(dev, dtype, B_free, B_contact, B_worm):
    """name -> (kernel wrapper, plain version, args, kwargs) at chip_smoke.py's
    inputs for the given batches of each path, T = 100."""
    out = {}
    ki = cs.kernel_inputs(dev, B_free, cs.H, dtype)
    for name in cs.KERNELS:
        out[name] = (cs.KERNELS[name], cs.PLAIN[name], ki[name], {})
    ci = cs.contact_kernel_inputs(dev, B_contact, cs.H, dtype)
    for name in cs.CONTACT_KERNELS:
        out[name] = (cs.CONTACT_KERNELS[name], cs.CONTACT_PLAIN[name], *ci[name])
    wi = cs.worm_kernel_inputs(dev, B_worm, cs.H, dtype)
    for name in cs.WORM_KERNELS:
        out[name] = (cs.WORM_KERNELS[name], cs.WORM_PLAIN[name], *wi[name])
    model, pre, u, classes, _ = wi["linearize_vjp"][0]
    out["linearize_split[worm]"] = (cs.linearize_split, cs.linearize_split_plain,
                                    (model, pre, u, classes), {})
    return out


def coupled_calls(dev, dtype):
    model, x, u, cm, us = cs.worm_sliding_points(dev, dtype, cs.WORM_COUPLED_B)
    rc, fc = cs.worm_costs(model)
    B, nx = x.shape
    classes = (cm[:, None].contiguous(), us[:, None].contiguous())
    x1, u1 = x[:, None].contiguous(), u[:, None].contiguous()
    out = {}
    for cg in cs.COUPLED_CG:
        out[f"rollout_gains[worm] sliding cg={cg}"] = (
            cs.rollout_gains, cs.rollout_gains_plain,
            (model, rc, fc, x, x.new_zeros(B, 2, nx), u1, x.new_zeros(B, 1, 2, nx),
             x.new_zeros(B, 1, 2), x.new_ones(1)), {"classes": classes, "cg_iters": cg})
        out[f"linearize_vjp sliding cg={cg}"] = (cs.linearize_vjp, cs.linearize_vjp_plain,
                                                 (model, x1, u1, classes, cg), {})
        out[f"linearize_split[worm] sliding cg={cg}"] = (
            cs.linearize_split, cs.linearize_split_plain, (model, x1, u1, classes),
            {"cg_iters": cg})
    return out


def flat(o):
    """The floating-point tensors of a (nested) output tuple."""
    if isinstance(o, torch.Tensor):
        return [o] if o.dtype.is_floating_point else []
    return [t for x in o for t in flat(x)]


def error(out_k, out_p) -> dict:
    pairs = list(zip(flat(out_k), flat(out_p)))
    nonfinite = sum(int((~torch.isfinite(a)).sum()) for a, _ in pairs)
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in pairs)
    return {"nonfinite": nonfinite, "max_rel_err": rel}


def main() -> int:
    global OUT
    if "--out" in sys.argv:
        OUT = Path(sys.argv[sys.argv.index("--out") + 1]).resolve()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    shutil.rmtree(OUT, ignore_errors=True)
    variants = TIMED + FAULT
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(variants, pool.map(build, variants)))
        lcp_s = dict(zip(("as_built", "all_rolled"),
                         pool.map(build_lcp_alone, ("as_built", "all_rolled"))))
        sass = dict(zip(SASS, pool.map(sass_counts, SASS)))
    result = {"device": torch.cuda.get_device_name(0), "lcp_alone_build_s": lcp_s,
              "k5_f64_sass_instructions": sass}
    print(f"lcp.cu alone: {lcp_s} s; K5 f64 SASS instructions: {sass}", flush=True)
    libs = {}
    for v, (path, seconds, log) in built.items():
        table = ptxas_table(log)
        result[v] = {"build_s": seconds, "ptxas": table}
        print(f"{v}: one nvcc call, {seconds:.1f} s (8 builds at a time)", flush=True)
        for entry, row in sorted(table.items()):
            print(f"  {row}  {entry[:110]}")
        libs[v] = load(path)

    def use(v):
        _build.load = lambda: libs[v]

    def check(group):
        """Each variant of the group against the plain versions at small
        batches; returns False after a launch fails (the card's context is
        then lost, so nothing more can run)."""
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            cases = dict(calls(dev, dtype, B_SMALL, B_SMALL, B_SMALL), **coupled_calls(dev, dtype))
            for name, (kern, plain, args, kw) in cases.items():
                want = plain(*args, **kw)
                for v in group:
                    use(v)
                    try:
                        got = kern(*args, **kw)
                        torch.cuda.synchronize()
                        e = error(got, want)
                    except Exception as exc:  # a CUDA error, whatever its class
                        e = {"launch_failed": str(exc).splitlines()[0]}
                    result[v].setdefault("check", {})[f"{name} {dname}"] = e
                    print(f"  {v:14s} {name:40s} {dname}: {e}", flush=True)
                    if "launch_failed" in e:
                        return False
        return True

    check(TIMED)
    full = calls(dev, torch.float32, cs.B_FULL, cs.B_CONTACT, cs.WORM_B)
    print(f"[{time.perf_counter() - t0:.1f} s] timing at the paths' shapes, f32", flush=True)
    for name, (kern, _, args, kw) in full.items():
        reps = 3 if "worm" in name or name in ("linearize_vjp", "pgs_batched") else 20
        times = {v: [] for v in TIMED}
        for v in TIMED + TIMED[::-1]:
            use(v)
            times[v].append(cs.time_ms(lambda: kern(*args, **kw), reps))
        for v in TIMED:
            result[v].setdefault("ms", {})[name] = times[v]
        print(f"  {name:28s} " + ", ".join(f"{v} {times[v]}" for v in TIMED), flush=True)
    del full
    print(f"[{time.perf_counter() - t0:.1f} s] the fault's variants", flush=True)
    check(FAULT)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    (OUT / "unroll_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({v: {k: result[v][k] for k in ("build_s", "ms")} for v in TIMED}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
