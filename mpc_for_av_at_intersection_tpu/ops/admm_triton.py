"""Pallas (Triton route) kernel: one check block of ADMM iterations.

Twin of ``mpc.qp._admm_block_xla``. The XLA scan streams every scenario's
``Minv`` (n, n) and ``G`` (m, n) from device memory on every iteration: at
B=4096, T=20 (n=40, m=79) that is ~130 MB per iteration, more than the
card's L2. Here one program owns one scenario: it loads its ``Minv`` and
``G`` once, keeps them in registers for all ``iters`` iterations of the
block, and writes back only (x, z, y). The factorization, residuals and rho
adaptation stay in XLA.

Triton wants power-of-two tensors, so n and m are padded inside the kernel
by masked loads (zeros): a zero row/column leaves the padded entries of x,
z and y at exactly zero through every iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NUM_WARPS = 4


def _kernel(minv_ref, g_ref, q_ref, lo_ref, hi_ref, rho_ref, run_ref,
            x_ref, z_ref, y_ref, xo_ref, zo_ref, yo_ref,
            *, n, m, iters, sigma, alpha):
    NP = pl.next_power_of_2(n)
    MP = pl.next_power_of_2(m)
    nmask = jnp.arange(NP, dtype=jnp.int32) < n
    mmask = jnp.arange(MP, dtype=jnp.int32) < m
    zero = jnp.zeros((), x_ref.dtype)

    def vec(ref, size, mask):
        return plgpu.load(ref.at[pl.ds(0, size)], mask=mask, other=zero)

    Minv = plgpu.load(minv_ref.at[pl.ds(0, NP), pl.ds(0, NP)],
                      mask=nmask[:, None] & nmask[None, :], other=zero)
    G = plgpu.load(g_ref.at[pl.ds(0, MP), pl.ds(0, NP)],
                   mask=mmask[:, None] & nmask[None, :], other=zero)
    q = vec(q_ref, NP, nmask)
    lo = vec(lo_ref, MP, mmask)
    hi = vec(hi_ref, MP, mmask)
    rho = rho_ref[...]

    def it(_, carry):
        x, z, y = carry
        t = rho * z - y
        rhs = sigma * x - q + jnp.sum(G * t[:, None], axis=0)
        xt = jnp.sum(Minv * rhs[None, :], axis=1)
        gxt = jnp.sum(G * xt[None, :], axis=1)
        xn = alpha * xt + (1.0 - alpha) * x
        zt = alpha * gxt + (1.0 - alpha) * z
        zn = jnp.minimum(jnp.maximum(zt + y / rho, lo), hi)
        yn = y + rho * (zt - zn)
        return xn, zn, yn

    # converged (frozen) scenarios run zero iterations (run is 0 or 1; a
    # select here lowers to an i1 loop bound in the Triton route)
    n_it = run_ref[...] * iters
    x, z, y = jax.lax.fori_loop(
        0, n_it, it,
        (vec(x_ref, NP, nmask), vec(z_ref, MP, mmask), vec(y_ref, MP, mmask)))
    plgpu.store(xo_ref.at[pl.ds(0, NP)], x, mask=nmask)
    plgpu.store(zo_ref.at[pl.ds(0, MP)], z, mask=mmask)
    plgpu.store(yo_ref.at[pl.ds(0, MP)], y, mask=mmask)


def admm_block_triton(Minv, Gs, qs, los, his, rho, run, x, z, y, *,
                      iters: int, sigma: float, alpha: float,
                      interpret: bool = False):
    """``iters`` ADMM iterations for each scenario with ``run`` set.

    Minv (B, n, n), Gs (B, m, n), qs/x (B, n), los/his/z/y (B, m), rho (B,),
    run (B,) bool. Returns (x, z, y). ``interpret=True`` runs the kernel in
    the Pallas interpreter (CPU tests)."""
    n = x.shape[1]
    m = z.shape[1]
    kernel = functools.partial(_kernel, n=n, m=m, iters=iters,
                               sigma=float(sigma), alpha=float(alpha))
    dt = x.dtype
    # under shard_map the outputs vary over the same mesh axes as x
    vma = jax.typeof(x).vma
    call = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((n,), dt, vma=vma),
                   jax.ShapeDtypeStruct((m,), dt, vma=vma),
                   jax.ShapeDtypeStruct((m,), dt, vma=vma)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="admm_block",
    )
    return jax.vmap(call)(Minv, Gs, qs, los, his, rho.astype(dt),
                          run.astype(jnp.int32), x, z, y)
