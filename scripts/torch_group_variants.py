#!/usr/bin/env python3
"""The kernels' layouts (the worm's lane groups, the cartpole contact
kernels' designs) against a base tree's kernels, on one card in one call.

    python3 scripts/torch_group_variants.py --base DIR [--variants LIST] [--out DIR]
                                            [--kernels LIST] [--replans LIST]

``DIR`` (``--base``) holds an unpacked tree of the commit to compare with
(``git archive <commit> nimblephysics_tpu_torch/csrc | tar -x -C DIR``);
its ``nimblephysics_tpu_torch/csrc`` is built as it is ("base"). This
tree's sources are built as they are ("as_built") and in the variants of
VARIANTS, each of which sets some of the layout constants
(csrc/frozen_group.cuh: the lanes of K2's, K5's and K4's groups, kK2Group,
kK5Group, kK4Group, and K4's tangent right-hand sides per pass over Qf,
kK4Rhs; csrc/lcp.cu: K7's, kK7Group; the cartpole's layouts,
frozen_group.cuh kK4PointRhs, the one-thread K4's tangent PCGs per pass,
and csrc/rollout.cu kK2Threads, the one-thread K2's threads per block; or
"small_unrolled", scripts/torch_unroll_variants.py's plain ``#pragma
unroll`` on the small loops);
``--variants`` picks some of them
(comma-separated; by default all). All ``nvcc`` calls run at once, into
``--out`` (by default the gitignored
``nimblephysics_tpu_torch/_build/group_variants/``). It prints each build's
time and ptxas's registers, stack and spills for the worm's kernels, K7
and the cartpole instances of K2 and K4, and for the cartpole instances
the counts of some SASS instructions (``cuobjdump -sass``: local loads and
stores LDL and STL, MUFU by function, CALL, and those calls that name a
division's slow path, FCHK, the f32 division's check), then in f32 and
f64:

  * each library's kernels of KERNELS (``--kernels`` picks some) against
    the plain versions (largest relative error; chip_smoke.py holds the
    kept build to its rules), and their times (CUDA events, the libraries
    in turns forth and back, 3 calls each). At the worm path's shapes
    (chip_smoke.py's worm inputs, B=2048, T=100, PCG depth 12): K2 (worm),
    K5, K9 and K8, K2 and K5 also at PCG depth 1 (the PCG's share of their
    time), K3 with classes= (K4's kernel at depth m + 6), K4 at depth 12
    and K7. At the cartpole contact path's shapes (chip_smoke.py's phase 5
    inputs on the narrowed cartpole, B=2048, T=100, A=6, PCG depth m + 6 =
    10): K2 with classes, also at A=1 (one alpha: a latency-bound kernel
    takes about as long) and at PCG depth 1, and K4, also at PCG depth 1;
    K2 without classes at the contact-free path's shapes (phase 3b's, B=4096);
  * in f32, each library's replans of REPLANS (``--replans``), 3 calls
    each, in turns: the warm worm replans (ILQRConfig(linearize=...):
    "auto", bench.py's row, and "jvp", K3 classes=; "split" and "chain" on
    request), warm from one cold replan of the first library after "base";
    the cartpole contact replans ("cartpole_limits", stock limits, and
    "cartpole_limits_narrow", chip_smoke.py phase 7's) and the
    contact-free one ("cartpole_free", phase 4's), after one untimed call.

The last line is one JSON object with every number, with the card's name
and power limit; ``DIR/group_variants.json`` (``--out``) has the same.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nimblephysics_tpu_torch.ops import _build  # noqa: E402
from nimblephysics_tpu_torch.trajectory import ilqr  # noqa: E402
from torch_unroll_variants import ptxas_table  # noqa: E402
from torch_unroll_variants import transform as unroll_transform  # noqa: E402

OUT = _build.BUILD_ROOT / "group_variants"
# each layout constant, the file that declares it and its declaration
CONSTANTS = {
    "kK2Group": ("frozen_group.cuh", r"kK2Group = \d+"),
    "kK5Group": ("frozen_group.cuh", r"kK5Group = \d+"),
    "kK4Group": ("frozen_group.cuh", r"kK4Group = \d+"),
    "kK4Rhs": ("frozen_group.cuh", r"kK4Rhs = \d+"),
    "kK7Group": ("lcp.cu", r"kK7Group = \d+"),
    "kK4PointRhs": ("frozen_group.cuh", r"kK4PointRhs = \d+"),
    "kK2Threads": ("rollout.cu", r"kK2Threads = \d+"),
    "kK1Lanes": ("riccati.cu", r"kK1Lanes = \d+"),
    "kK1Chunk": ("riccati.cu", r"kK1Chunk = \d+"),
    "kK3Threads": ("linearize_free.cu", r"kK3Threads = \d+"),
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
    "small_unrolled": {"_unroll": "small_unrolled"},
    "k2t128": {"kK2Threads": 128},
    "k2t64_k4np5": {"kK2Threads": 64, "kK4PointRhs": 5},
    "k1_thread": {"kK1Lanes": 1},
    "k1_c4": {"kK1Chunk": 4},
    "k1_c16": {"kK1Chunk": 16},
    "k3_t256": {"kK3Threads": 256},
}
# the worm's kernels (its shape in the mangled names) and K7's, in ptxas's output
WORM_SHAPE = "Li3ELi4ELi2ELi28ELi8E"
ENTRIES = ("rollout_kernel", "rollout_group_kernel", "linearize_vjp", "linearize_split_kernel",
           "linearize_jvp_group", "pgs_kernel", "pgs_group")
# the cartpole's contact shape (2, 2, 1, 4, 0) and its contact-free one, in
# mangled names: every kernel instanced at them is tabled and counted
CART_SHAPES = ("Li2ELi2ELi1ELi4ELi0E", "Li2ELi2ELi1ELi0ELi0E")
SASS_OPS = ("LDL", "STL", "MUFU", "CALL", "FCHK", "LDG", "STG", "LDS", "STS", "SHFL", "BAR")
WORM_KERNEL_NAMES = ("rollout_gains[worm]", "rollout_gains[worm] PCG depth 1",
                     "linearize_vjp PCG depth 1", "linearize_vjp", "chained_step_rollout",
                     "chained_linearize_vjp", "linearize[classes]", "linearize_split[worm]",
                     "pgs_batched")
CART_KERNEL_NAMES = ("rollout_gains[cartpole classes]", "rollout_gains[cartpole classes] A=1",
                     "rollout_gains[cartpole classes] PCG depth 1", "rollout_gains[cartpole]",
                     "linearize_split[cartpole]", "linearize_split[cartpole] PCG depth 1")
KERNELS = WORM_KERNEL_NAMES + CART_KERNEL_NAMES
CART_REPLANS = ("cartpole_limits", "cartpole_limits_narrow", "cartpole_free")
REPLANS = ("auto", "jvp", "split", "chain") + CART_REPLANS + ("none",)
REPS = 3
# K1 at (4, 1) (the cartpole, B=4096) and at (8, 2) (the worm, B=2048), K3
# (the cartpole, B=4096): each timed as its wrapper call and as its launch
# alone (CUDA events around the nptt_* call only, inputs packed before),
# K1 also alone at T = 1 and 10 (the cost per step)
K1K3_NAMES = ("riccati_backward", "riccati_backward[worm]", "linearize")
K1_STEPS = (1, 10)
# the kernels of K1 and K3 in ptxas's output and in the SASS
K1K3_ENTRIES = ("riccati", "linearize_kernel", "linearize_dir")
# PR 9's K1 launcher: the inputs packed to (T, E, B), (K, k) out as (T, Eo, B)
LEGACY_RICCATI = [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 8


def transform(name: str, text: str, file: str) -> str:
    """The source of one variant (VARIANTS; "_unroll" names a variant of
    scripts/torch_unroll_variants.py applied first)."""
    for const, value in VARIANTS[name].items():
        if const == "_unroll":
            text = unroll_transform(value, text)
            continue
        where, pattern = CONSTANTS[const]
        if file != where:
            continue
        if not re.search(pattern, text):
            raise RuntimeError(f"{file} no longer declares {const} as expected")
        text = re.sub(pattern, f"{const} = {value}", text)
    return text


def build(name: str, csrc: Path):
    """(library, seconds, nvcc's output) of csrc's .cu files built as the
    port builds them (_build.compile_library: one nvcc per file at once),
    transformed for a variant other than "base"."""
    src = OUT / name / "src"
    src.mkdir(parents=True, exist_ok=True)
    for p in csrc.iterdir():
        if p.suffix in (".cu", ".cuh"):
            text = p.read_text()
            if name != "base":
                text = transform(name, text, p.name)
            (src / p.name).write_text(text)
    lib = OUT / name / _build.LIB_NAME
    seconds, log = _build.compile_library(
        sorted(p for p in src.iterdir() if p.suffix == ".cu"), lib)
    return lib, seconds, log


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


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or str(Path(_build._nvcc()).parent / "cuobjdump")


def sass_counts(lib: Path) -> dict:
    """Per kernel instanced at a cartpole shape (CART_SHAPES) and of K1 and
    K3 (K1K3_ENTRIES): its SASS instructions in all and those of SASS_OPS
    (MUFU also by function, CALL also where the line names a division's
    slow path), from ``cuobjdump -sass``. K3's f32 kernels' SASS goes to
    ``k3.sass`` beside the library (where its local loads sit)."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=900).stdout
    keep, dump = False, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            keep = "linearize" in m.group(1) and "IfLi2ELi2ELi1EE" in m.group(1)
        if keep:
            dump.append(line)
    (lib.parent / "k3.sass").write_text("\n".join(dump) + "\n")
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(c in m.group(1) for c in CART_SHAPES + K1K3_ENTRIES) else None
            if fn:
                counts[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.\w+)*)",
                      line)
        if fn is None or not m:
            continue
        op = m.group(1)
        counts[fn]["instructions"] += 1
        if op in SASS_OPS:
            counts[fn][op] += 1
        if op == "MUFU":
            counts[fn]["MUFU" + m.group(2)] += 1
        if op == "CALL" and "div" in line.lower():
            counts[fn]["CALL div slow path"] += 1
    return {f: dict(c) for f, c in counts.items()}


def local_placement(sass: str) -> dict:
    """Where the local loads and stores (LDL, STL) of each function of a
    ``cuobjdump -sass`` dump sit: inside a loop (between a backward
    branch's target and the branch) or in straight-line code, and by tenth
    of the function's instructions, and the calls (CALL) likewise."""
    out, fn, ins, labels, pending = {}, None, [], {}, []

    def close():
        if fn is None:
            return
        resolved = [(a, op, labels.get(t, t) if isinstance(t, str) else t) for a, op, t in ins]
        loops = [(t, a) for a, op, t in resolved if op == "BRA" and t is not None and t <= a]
        n = len(resolved)
        row = {"instructions": n, "loops": len(loops)}
        for kind in ("LDL", "STL", "CALL"):
            at = [(i, a) for i, (a, op, _) in enumerate(resolved) if op == kind]
            row[kind] = len(at)
            row[kind + " in loops"] = sum(any(lo <= a <= hi for lo, hi in loops) for _, a in at)
            row[kind + " by tenth"] = [sum(10 * i // max(n, 1) == d for i, _ in at)
                                       for d in range(10)]
        out[fn] = row

    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            fn, ins, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn is None or not m:
            continue
        addr, op, t = int(m.group(1), 16), m.group(2), None
        for lab in pending:
            labels[lab] = addr
        pending = []
        if op == "BRA":
            rest = line[m.end():]
            lab = re.search(r"(\.L_x_\d+)", rest)
            hexa = re.search(r"0x([0-9a-f]+)", rest)
            t = lab.group(1) if lab else (int(hexa.group(1), 16) if hexa else None)
        ins.append((addr, op, t))
    close()
    return out


def cart_kernel_calls(dev, dtype, chosen):
    """name -> (kernel call, plain call) of the cartpole kernels of
    CART_KERNEL_NAMES in ``chosen``: chip_smoke.py's phase 5 inputs (the
    narrowed cartpole) at the contact path's shapes and phase 3b's for K2
    without classes."""
    if not set(chosen) & set(CART_KERNEL_NAMES):
        return {}
    inputs = cs.contact_kernel_inputs(dev, cs.B_CONTACT, cs.H, dtype)
    a2, k2 = inputs["rollout_gains[classes]"]
    a4, _ = inputs["linearize_split"]
    a2_1 = a2[:-1] + (a2[-1][:1].contiguous(),)
    free = cs.kernel_inputs(dev, cs.B_FULL, cs.H, dtype)["rollout_gains"]
    k2d1 = dict(k2, cg_iters=1)
    calls = {
        "rollout_gains[cartpole classes]": (lambda: cs.rollout_gains(*a2, **k2),
                                            lambda: cs.rollout_gains_plain(*a2, **k2)),
        "rollout_gains[cartpole classes] A=1": (lambda: cs.rollout_gains(*a2_1, **k2),
                                                lambda: cs.rollout_gains_plain(*a2_1, **k2)),
        "rollout_gains[cartpole classes] PCG depth 1": (
            lambda: cs.rollout_gains(*a2, **k2d1), lambda: cs.rollout_gains_plain(*a2, **k2d1)),
        "rollout_gains[cartpole]": (lambda: cs.rollout_gains(*free),
                                    lambda: cs.rollout_gains_plain(*free)),
        "linearize_split[cartpole]": (lambda: cs.linearize_split(*a4),
                                      lambda: cs.linearize_split_plain(*a4)),
        "linearize_split[cartpole] PCG depth 1": (
            lambda: cs.linearize_split(*a4, cg_iters=1),
            lambda: cs.linearize_split_plain(*a4, 1)),
    }
    return {k: v for k, v in calls.items() if k in chosen}


def kernel_calls(dev, dtype, chosen):
    """name -> (kernel call, plain call) on chip_smoke.py's worm inputs at
    the path's shapes, for the names in ``chosen``, and cart_kernel_calls'."""
    calls = cart_kernel_calls(dev, dtype, chosen)
    if not set(chosen) & set(WORM_KERNEL_NAMES):
        return calls
    inputs = cs.worm_kernel_inputs(dev, cs.WORM_B, cs.H, dtype)
    a2, k2 = inputs["rollout_gains[worm]"]
    a5, _ = inputs["linearize_vjp"]
    a7, _ = inputs["pgs_batched"]
    model, pre, u, classes, cg = a5
    rc, _ = cs.worm_costs(model)
    a9, k9 = (model, rc, pre[:, 0].contiguous(), u, classes), {"cg_iters": cg}
    k2_1, a5_1 = dict(k2, cg_iters=1), a5[:4] + (1,)
    calls.update({
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
    })
    return {k: v for k, v in calls.items() if k in chosen}


def riccati_is_legacy(lib) -> bool:
    """Whether a library's K1 takes PR 9's packed (T, E, B) layout: it
    lacks the layout query of the unpacked kernel."""
    return not hasattr(lib, "nptt_riccati_layout")


def riccati_calls(lib, args):
    """(the launch alone, the wrapper call) of K1 on ``lib`` with the
    wrapper's arguments. A legacy library gets PR 9's wrapper: the inputs
    packed to (T, E, B) by torch.cat and permute, (K, k) unpacked after."""
    args = tuple(a.contiguous() for a in args)
    fx, fu, lx, lu, lxx, luu, lux, VxT, VxxT, reg = args
    B, T, nx, na = fu.shape
    dev, dtype = fx.device, fx.dtype
    isd, stream = int(dtype == torch.float64), _build.stream_ptr(dev)
    dV = torch.empty((B, 2), dtype=dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if riccati_is_legacy(lib):
        lib.nptt_riccati.argtypes = LEGACY_RICCATI
        eo = na * nx + na

        def pack():
            return torch.cat([a.reshape(B, T, -1) for a in args[:7]],
                             dim=-1).permute(1, 2, 0).contiguous()

        steps, Kk = pack(), torch.empty((T, eo, B), dtype=dtype, device=dev)

        def launch(steps, Kk):
            _build.check(lib.nptt_riccati(isd, nx, na, B, T, steps.data_ptr(), VxT.data_ptr(),
                                          VxxT.data_ptr(), reg.data_ptr(), Kk.data_ptr(),
                                          dV.data_ptr(), ok.data_ptr(), stream), "legacy K1")

        def wrapper():
            steps, Kk = pack(), torch.empty((T, eo, B), dtype=dtype, device=dev)
            launch(steps, Kk)
            Kk = Kk.permute(2, 0, 1)
            return (Kk[..., : na * nx].reshape(B, T, na, nx).contiguous(),
                    Kk[..., na * nx:].contiguous(), dV, ok)

        return (lambda: launch(steps, Kk)), wrapper
    K = torch.empty((B, T, na, nx), dtype=dtype, device=dev)
    k = torch.empty((B, T, na), dtype=dtype, device=dev)

    def alone():
        _build.check(lib.nptt_riccati(isd, nx, na, B, T, *[a.data_ptr() for a in args],
                                      K.data_ptr(), k.data_ptr(), dV.data_ptr(), ok.data_ptr(),
                                      stream), "K1")

    return alone, (lambda: cs.riccati_backward(*args))


def linearize_calls(lib, args):
    """(the launch alone, the wrapper call) of K3 on ``lib``."""
    model, xs, u = args
    B, T, nx = xs.shape
    na = u.shape[-1]
    P, I = cs.device_step.pack_model(model)
    fx = torch.empty((B, T, nx, nx), dtype=xs.dtype, device=xs.device)
    fu = torch.empty((B, T, nx, na), dtype=xs.dtype, device=xs.device)
    isd, stream = int(xs.dtype == torch.float64), _build.stream_ptr(xs.device)

    def alone():
        _build.check(lib.nptt_linearize(isd, model.num_bodies, model.nq, na, B * T, P.data_ptr(),
                                        I.data_ptr(), xs.data_ptr(), u.data_ptr(), fx.data_ptr(),
                                        fu.data_ptr(), stream), "K3")

    return alone, (lambda: cs.linearize(*args))


def k1k3_inputs(dev, dtype, chosen):
    """name -> (wrapper arguments, plain call) of K1K3_NAMES in ``chosen``,
    at their paths' shapes (chip_smoke.py's phase 3b and phase 8b inputs),
    and K1 at T of K1_STEPS."""
    out = {}
    if {"riccati_backward", "linearize"} & set(chosen):
        free = cs.kernel_inputs(dev, cs.B_FULL, cs.H, dtype)
        for name in ("riccati_backward", "linearize"):
            out[name] = free[name]
    if "riccati_backward" in chosen:
        for T in K1_STEPS:
            out[f"riccati_backward T={T}"] = tuple(
                a[:, :T].contiguous() if i < 7 else a
                for i, a in enumerate(free["riccati_backward"]))
    if "riccati_backward[worm]" in chosen:
        out["riccati_backward[worm]"] = cs.worm_kernel_inputs(
            dev, cs.WORM_B, cs.H, dtype)["riccati_backward[worm]"][0]
    return {k: v for k, v in out.items() if k.split(" ")[0] in chosen}


def check_k1k3_f64(dev, chosen, libs_named, libs, use, result):
    """K1 and K3 of every library against their plain versions in f64 at
    chip_smoke.py's check sizes (phase 3's B=512 and (6, 3) inputs, phase
    8's worm inputs at B=512): the largest relative error and whether the
    PD flags agree."""
    inputs = {}
    if {"riccati_backward", "linearize"} & set(chosen):
        small = cs.kernel_inputs(dev, cs.B_CHECK, cs.H, torch.float64)
        inputs["riccati_backward"] = small["riccati_backward"]
        inputs["riccati_backward (6, 3)"] = cs.riccati_inputs(dev, torch.float64)
        inputs["linearize"] = small["linearize"]
    if "riccati_backward[worm]" in chosen:
        inputs["riccati_backward[worm]"] = cs.worm_kernel_inputs(
            dev, cs.WORM_B_CHECK, cs.H, torch.float64)["riccati_backward[worm]"][0]
    for kname, args in inputs.items():
        if kname.split(" ")[0] not in chosen:
            continue
        lin = kname == "linearize"
        want = (cs.linearize_plain if lin else cs.riccati_backward_plain)(*args)
        line = []
        for n in libs_named:
            use(n)
            got = (linearize_calls if lin else riccati_calls)(libs[n], args)[1]()
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(got, want) if a.dtype != torch.bool]
            err = rel_error([a for a, _ in pairs], [b for _, b in pairs])
            same = lin or bool(torch.equal(got[3], want[3]))
            result[n].setdefault("max_rel_err", {})[f"{kname} float64"] = err
            result[n].setdefault("ok_identical", {})[f"{kname} float64"] = same
            line.append(f"{n} {err:.2e}{'' if same else ' (ok flags differ)'}")
        print(f"  {kname:24s} float64 rel err: " + "; ".join(line), flush=True)


def time_k1k3(dev, dtype, chosen, libs_named, libs, use, result):
    """Each of k1k3_inputs' calls on every library, in turns forth and
    back: its error against the plain version, its wrapper's time (but at
    K1_STEPS) and its launch's alone."""
    dname = str(dtype).split(".")[-1]
    for kname, args in k1k3_inputs(dev, dtype, chosen).items():
        plain = cs.linearize_plain if kname == "linearize" else cs.riccati_backward_plain
        want = plain(*args)
        calls = {}
        for n in libs_named:
            use(n)
            calls[n] = (linearize_calls if kname == "linearize" else riccati_calls)(libs[n], args)
            got = calls[n][1]()
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(got, want) if a.dtype != torch.bool]
            result[n].setdefault("max_rel_err", {})[f"{kname} {dname}"] = rel_error(
                [a for a, _ in pairs], [b for _, b in pairs])
            if kname.startswith("riccati"):
                result[n].setdefault("ok_identical", {})[f"{kname} {dname}"] = bool(
                    torch.equal(got[3], want[3]))
        kinds = ("alone",) if " T=" in kname else ("wrapper", "alone")
        times = {(n, kind): [] for n in libs_named for kind in kinds}
        for n in libs_named + libs_named[::-1]:
            use(n)
            for kind in kinds:
                times[(n, kind)].append(cs.time_ms(calls[n][0 if kind == "alone" else 1], REPS * 4))
        for n in libs_named:
            for kind in kinds:
                result[n].setdefault("ms", {})[f"{kname} {kind} {dname}"] = times[(n, kind)]
        print(f"  {kname:24s} {dname}: " + "; ".join(
            f"{n} " + ", ".join(f"{kind} {times[(n, kind)][0]:.4f}/{times[(n, kind)][1]:.4f}"
                                for kind in kinds)
            + f" ms (rel err {result[n]['max_rel_err'][f'{kname} {dname}']:.2e})"
            for n in libs_named), flush=True)


def cart_replan(dev, name, libs_named, use, result, t0):
    """One cartpole replan of CART_REPLANS in f32, each library's 3 calls
    in turns forth and back after one untimed call; solves/s into
    ``result``."""
    if name == "cartpole_free":
        B = cs.B_FULL
        x0 = np.random.default_rng(cs.SEED).uniform(-0.3, 0.3, (B, 4))
        run = lambda: cs.solve(dev, torch.float32, True, x0, cs.H)[2]  # noqa: E731
    else:
        B, narrow = cs.B_CONTACT, name == "cartpole_limits_narrow"
        x0 = cs.contact_x0(B, narrow)
        run = lambda: cs.contact_solve(dev, torch.float32, True, x0, narrow)[2]  # noqa: E731
    print(f"[{time.perf_counter() - t0:.1f} s] the {name} replan, f32, B={B}", flush=True)
    use(libs_named[1])
    run()
    rates = {n: [] for n in libs_named}
    for n in libs_named + libs_named[::-1]:
        use(n)
        secs = [run() for _ in range(REPS)]
        rates[n].append(B / (sum(secs) / len(secs)))
    for n in libs_named:
        result[n][f"replan_solves_per_s {name}"] = rates[n]
    print(f"  {name} replan (solves/s, forth/back): " + "; ".join(
        f"{n} {rates[n][0]:.1f}/{rates[n][1]:.1f}" for n in libs_named), flush=True)


def arg_list(args, flag, default, allowed):
    chosen = args[args.index(flag) + 1].split(",") if flag in args else list(default)
    if not set(chosen) <= set(allowed):
        raise SystemExit(f"{flag}: choose among {list(allowed)}")
    return chosen


def main() -> int:
    global OUT
    args = sys.argv[1:]
    if "--sass" in args:
        # a dump written by sass_counts (k3.sass), read without a card
        for path in args[args.index("--sass") + 1:]:
            for fn, row in local_placement(Path(path).read_text()).items():
                print(f"{path}: {fn[:70]}: {row}")
        return 0
    if "--base" not in args:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(args[args.index("--base") + 1]).resolve() / "nimblephysics_tpu_torch" / "csrc"
    if "--out" in args:
        OUT = Path(args[args.index("--out") + 1]).resolve()
    chosen = arg_list(args, "--variants", VARIANTS, VARIANTS)
    kernels = arg_list(args, "--kernels", KERNELS + K1K3_NAMES, KERNELS + K1K3_NAMES)
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
        table = {e: r for e, r in full.items() if (any(k in e for k in ENTRIES)
                 and (WORM_SHAPE in e or "pgs" in e)) or any(c in e for c in CART_SHAPES)
                 or any(k in e for k in K1K3_ENTRIES)}
        # every other kernel should compile as in the base tree
        others = [e for e in full if e in base_table and e not in table]
        differ = [e for e in others if full[e] != base_table[e]]
        result[name] = {"build_s": seconds, "ptxas": table,
                        "ptxas_other_kernels_differ_from_base": {e: [base_table[e], full[e]]
                                                                 for e in differ}}
        print(f"{name}: built in {seconds:.1f} s ({len(jobs)} builds at a time); "
              f"{len(others) - len(differ)} of the other {len(others)} kernels compile with "
              f"the base's registers and stack", flush=True)
        for entry, row in sorted(table.items()):
            print(f"  {row}  {entry[:100]}", flush=True)
        for entry in differ:
            print(f"  differs from base: {base_table[entry]} -> {full[entry]}  {entry[:90]}",
                  flush=True)
        # the worm's kernels and K7 against the base's
        worm = [e for e in table if (WORM_SHAPE in e or "pgs" in e) and e in base_table]
        worm_differ = [e for e in worm if full[e] != base_table[e]]
        result[name]["worm_kernels_differ_from_base"] = {e: [base_table[e], full[e]]
                                                         for e in worm_differ}
        print(f"  {len(worm) - len(worm_differ)} of the {len(worm)} worm and K7 kernels compile "
              f"with the base's registers and stack", flush=True)
        try:
            sass = sass_counts(path)
        except (OSError, subprocess.SubprocessError) as e:
            sass = {"error": repr(e)}
        result[name]["sass"] = sass
        for entry, row in sorted(sass.items()):
            print(f"  SASS {row}  {entry[:100]}", flush=True)
        libs[name] = load(path)
        if not riccati_is_legacy(libs[name]):
            for nx, na in ((4, 1), (8, 2)):
                out = (ctypes.c_longlong * 4)()
                libs[name].nptt_riccati_layout(0, nx, na, out)
                result[name][f"k1_layout ({nx}, {na})"] = list(out)
                print(f"  K1 ({nx}, {na}) f32: {out[0]} lanes per world, {out[1]} worlds per "
                      f"block, chunks of {out[2]} steps, {out[3]} shared bytes per block",
                      flush=True)

    real_k1 = ilqr.riccati_backward

    def use(name):
        _build.load = lambda: libs[name]
        # the replans call K1 through ilqr; a legacy library gets PR 9's wrapper
        ilqr.riccati_backward = ((lambda *a: riccati_calls(libs[name], a)[1]())
                                 if riccati_is_legacy(libs[name]) else real_k1)

    for dtype in (torch.float32, torch.float64):
        if dtype == torch.float32:
            time_k1k3(dev, dtype, kernels, libs_named, libs, use, result)
        else:
            check_k1k3_f64(dev, kernels, libs_named, libs, use, result)
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
        if lin == "none":
            continue
        if lin in CART_REPLANS:
            cart_replan(dev, lin, libs_named, use, result, t0)
            continue
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
    # the last line: the measured numbers only (the layouts, ptxas rows and
    # SASS counts are in the file)
    print(json.dumps({n: {k: result[n][k] for k in ("build_s", "ms", "max_rel_err", "ok_identical")
                          if k in result[n]} if isinstance(result[n], dict) else result[n]
                      for n in result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
