#!/usr/bin/env python3
"""How far rounding decides u in the f64 contact replan, on a card.

    python3 scripts/torch_contact_u_sensitivity.py

Runs chip_smoke.py's phase-6 replan (``solve_contact_mpc_batch``, narrowed
limits, B=256, H=100, 8 iterations, f64) on the kernel path and the plain
path, from x0 and from x0 +-1e-13 on both, and the plain path twice from
x0 (to show it is deterministic). Prints the worlds where the kernel and
plain paths' u differ by more than 1e-8 and by more than twice the plain
path's own move, each with both paths' own moves, the largest feedforward
|k| of the last iteration and the relative cost improvement of each
iteration; and how many worlds end in improvements below rel 1e-12. Needs
one CUDA card.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

B = 256


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    dev, f64 = torch.device("cuda"), torch.float64
    x0 = cs.contact_x0(B, True)
    runs = {}
    for name, kernels, shift in (("k", True, 0.0), ("p", False, 0.0), ("p2", False, 0.0),
                                 ("p+", False, 1e-13), ("p-", False, -1e-13),
                                 ("k+", True, 1e-13), ("k-", True, -1e-13)):
        runs[name] = cs.contact_solve(dev, f64, kernels, x0 + shift, True)[0]

    def move(a, b):
        return (runs[a].u - runs[b].u).abs().amax(dim=(1, 2))

    du = move("k", "p")
    mp = torch.maximum(move("p+", "p"), move("p-", "p"))
    mk = torch.maximum(move("k+", "k"), move("k-", "k"))
    print(f"plain path run twice: max |du| {float(move('p2', 'p').max()):.3e}")
    bad = ((du > 1e-8) & (du > 2 * mp)).nonzero().flatten().tolist()
    print(f"worlds beyond twice the plain path's own move: {bad}")
    print("of those beyond twice the larger own move: "
          f"{((du > 1e-8) & (du > 2 * torch.maximum(mp, mk))).nonzero().flatten().tolist()}")
    hist = runs["k"].cost_history
    impr = (hist[:-1] - hist[1:]) / hist[:-1].abs()
    k_last = runs["p"].k.abs().amax(dim=(1, 2))
    for b in bad:
        print(f"world {b}: |du| {float(du[b]):.3e}, plain move {float(mp[b]):.3e}, kernel move "
              f"{float(mk[b]):.3e}, |k_last| {float(k_last[b]):.3e}, rel improvements "
              f"{['%.1e' % v for v in impr[:, b].tolist()]}")
    tiny = ((impr[-3:] < 1e-12) & (impr[-3:] > 0)).any(0)
    print(f"worlds taking an improvement below rel 1e-12 in the last 3 iterations: "
          f"{int(tiny.sum())} of {B}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
