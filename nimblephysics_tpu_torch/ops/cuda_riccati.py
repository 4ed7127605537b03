"""K1: the batched iLQR Riccati backward pass.

Port of ``nimblephysics_tpu/ops/pallas_riccati.py :: riccati_backward_pallas``.
``riccati_backward`` launches the CUDA kernel of ``csrc/riccati.cu`` on CUDA
tensors, which reads the inputs where they lie and writes (K, k) in place
(no packing), and runs ``riccati_backward_plain``, a batched loop over t
with the kernel's arithmetic, on CPU tensors.
"""

from __future__ import annotations

import torch

from nimblephysics_tpu_torch.ops import _build
from nimblephysics_tpu_torch.ops.linalg_small import inv_spd_pivots

def riccati_backward_plain(fx, fu, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg):
    """Plain PyTorch backward pass with Tassa regularisation (Quu + reg
    fu^T fu, Qux + reg fu^T fx), pivot-free inverse of Quu_reg and the
    positive-definiteness flag from its smallest pivot.

    Returns K (B, T, na, nx), k (B, T, na), dV (B, 2), ok (B,) bool."""
    B, T, nx, na = fu.shape
    Vx, Vxx = Vx_T, Vxx_T
    r = reg[:, None, None]
    dv0 = Vx.new_zeros(B)
    dv1 = Vx.new_zeros(B)
    ok = torch.ones(B, dtype=torch.bool, device=fx.device)
    Ks, ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        fx_t, fu_t = fx[:, t], fu[:, t]
        fxT, fuT = fx_t.transpose(-1, -2), fu_t.transpose(-1, -2)
        Qx = lx[:, t] + (fxT @ Vx[..., None])[..., 0]
        Qu = lu[:, t] + (fuT @ Vx[..., None])[..., 0]
        W = Vxx @ fx_t
        Wu = Vxx @ fu_t
        Qxx = lxx[:, t] + fxT @ W
        Quu = luu[:, t] + fuT @ Wu
        Qux = lux[:, t] + fuT @ W
        Quu_reg = Quu + r * (fuT @ fu_t)
        Qux_reg = Qux + r * (fuT @ fx_t)
        Quu_inv, min_piv = inv_spd_pivots(Quu_reg)
        ok = ok & torch.isfinite(min_piv) & (min_piv > 0.0)
        k_t = -(Quu_inv @ Qu[..., None])[..., 0]
        K_t = -(Quu_inv @ Qux_reg)
        Kt = K_t.transpose(-1, -2)
        Quu_k = (Quu @ k_t[..., None])[..., 0]
        Vx = (Qx + (Kt @ (Quu_k + Qu)[..., None])[..., 0]
              + (Qux.transpose(-1, -2) @ k_t[..., None])[..., 0])
        V2 = Kt @ Qux
        Vn = Qxx + (Kt @ Quu) @ K_t + V2 + V2.transpose(-1, -2)
        Vxx = 0.5 * (Vn + Vn.transpose(-1, -2))
        dv0 = dv0 + (k_t * Qu).sum(-1)
        dv1 = dv1 + 0.5 * (k_t * Quu_k).sum(-1)
        Ks[t], ks[t] = K_t, k_t
    return (torch.stack(Ks, dim=1), torch.stack(ks, dim=1),
            torch.stack([dv0, dv1], dim=-1), ok)


def riccati_backward(fx, fu, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg):
    """Batched Riccati backward pass; returns (K, k, dV, ok) as
    ``riccati_backward_plain``. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    name = "riccati_backward"
    dev, dtype = _build.check_inputs(
        name, dict(fx=fx, fu=fu, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux,
                   Vx_T=Vx_T, Vxx_T=Vxx_T, reg=reg))
    if fu.dim() != 4:
        raise ValueError(f"{name}: fu must be (B, T, nx, na)")
    B, T, nx, na = fu.shape
    for key, t, shape in (
        ("fx", fx, (B, T, nx, nx)), ("lx", lx, (B, T, nx)), ("lu", lu, (B, T, na)),
        ("lxx", lxx, (B, T, nx, nx)), ("luu", luu, (B, T, na, na)),
        ("lux", lux, (B, T, na, nx)), ("Vx_T", Vx_T, (B, nx)),
        ("Vxx_T", Vxx_T, (B, nx, nx)), ("reg", reg, (B,)),
    ):
        _build.check_shape(name, key, t, shape)
    if dev.type == "cpu":
        return riccati_backward_plain(fx, fu, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg)
    if B < 1 or T < 1:
        raise ValueError(f"{name}: empty batch or horizon (B={B}, T={T})")
    # the kernel reads each input where it lies, a world's steps contiguous;
    # only an input that is not contiguous is copied
    ins = [a if a.is_contiguous() else a.contiguous()
           for a in (fx, fu, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg)]
    K = torch.empty((B, T, na, nx), dtype=dtype, device=dev)
    k = torch.empty((B, T, na), dtype=dtype, device=dev)
    dV = torch.empty((B, 2), dtype=dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = _build.load()
    rc = lib.nptt_riccati(
        int(dtype == torch.float64), nx, na, B, T, *[a.data_ptr() for a in ins],
        K.data_ptr(), k.data_ptr(), dV.data_ptr(), ok.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    riccati_backward.launches += 1
    return K, k, dV, ok


riccati_backward.launches = 0
