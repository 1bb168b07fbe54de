"""Card-only checks (marker `gpu`): they skip without an NVIDIA GPU and
run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu -s tests/test_gpu.py

(chip_smoke.py runs them in its own process as its `kernels` phase). Each
prints one line per measurement; times are min-of-3 walls around
jax.block_until_ready after one compiling call.

* The per-level diagonal stage at the real [B, F, W] of 50^3 L8 and
  100^3 L13: the production single lax.linalg.cholesky + the boundary
  _tri_solve, against a 128-wide blocked right-looking Cholesky + the same
  solve (the form the factor used before the GPU measurements chose the
  plain one).
* The double-float ELL residual (refine.df_matvec / df_matvec_multi)
  against an f64 CSR matvec on the host, beside a plain f64 ELL matvec on
  the card.
"""

import time

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

PROBLEMS = {"50^3": ((50, 50, 50), 8), "100^3": ((100, 100, 100), 13)}

# Bound on ||L L^T - A||_F / ||A||_F of a factored pivot block. Under
# 'default' the blocked variant's trailing-update matmuls may run as TF32
# (unit roundoff 2^-11 = 4.9e-4); under 'highest' every matmul is full f32
# (2^-24 = 6e-8) and the bound leaves room for growth ~sqrt(W) at W=10000.
DIAG_TOL = {"default": 1e-2, "highest": 5e-5}


@pytest.fixture
def card():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/test_gpu.py")
    return jax.devices()[0]


def _wall(fn, *args, reps=3):
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def _blocked_cholesky(a, bs=128):
    """Batched blocked right-looking Cholesky of [B, W, W] (lower triangle
    read): [B, bs, bs] diagonal POTRFs, panel TRSMs and trailing-update
    matmuls — the alternative the plain form is measured against."""
    import jax.numpy as jnp
    from jax import lax

    from cholesky_tpu.numeric import frontal

    W = a.shape[1]
    if W <= bs:
        return lax.linalg.cholesky(a, symmetrize_input=False)
    out = jnp.zeros_like(a)
    for c0 in range(0, W, bs):
        w = min(bs, W - c0)
        ld = lax.linalg.cholesky(a[:, c0:c0 + w, c0:c0 + w],
                                 symmetrize_input=False)
        out = out.at[:, c0:c0 + w, c0:c0 + w].set(ld)
        if c0 + w < W:
            x = frontal._tri_solve(ld, a[:, c0 + w:, c0:c0 + w],
                                   left_side=False, lower=True,
                                   transpose_a=True)
            out = out.at[:, c0 + w:, c0:c0 + w].set(x)
            a = a.at[:, c0 + w:, c0 + w:].add(
                -jnp.einsum("bik,bjk->bij", x, x,
                            preferred_element_type=x.dtype))
    return out


def _recon_err(L, piv, W):
    """||L L^T - sym(A)||_F / ||sym(A)||_F in f64 on the card, A the lower
    triangle of the pivot block."""
    import jax.numpy as jnp

    a = piv[:, :W, :].astype(jnp.float64)
    a = jnp.tril(a) + jnp.swapaxes(jnp.tril(a, -1), 1, 2)
    l64 = jnp.tril(L.astype(jnp.float64))
    d = jnp.einsum("bik,bjk->bij", l64, l64) - a
    return float(jnp.linalg.norm(d) / jnp.linalg.norm(a))


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_diag_stage_per_level(card, name, precision):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from cholesky_tpu.numeric import frontal
    from cholesky_tpu.symbolic.plan import build_plan
    from cholesky_tpu.utils.laplacian import generate_problem

    shape, levels = PROBLEMS[name]
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    fp = frontal.build_frontal_plan(build_plan(o, cl), r, c)
    fronts = frontal.assemble_fronts(fp, r, c, v, dtype=np.float32)
    for lvl in range(fp.levels - 1, -1, -1):
        W, F = fp.W[lvl], fp.F[lvl]
        piv = jnp.asarray(fronts[lvl])
        fronts[lvl] = None

        def stage(chol, p, W=W, F=F):
            L = chol(p[:, :W, :])
            if F == W:
                return L, L
            return L, frontal._tri_solve(L, p[:, W:, :], left_side=False,
                                         lower=True, transpose_a=True)

        blocked = jax.jit(lambda p: stage(_blocked_cholesky, p))
        plain = jax.jit(lambda p: stage(
            lambda a: lax.linalg.cholesky(a, symmetrize_input=False), p))
        with jax.default_matmul_precision(precision):
            (Lb, _), tb = _wall(blocked, piv)
            (Lp, _), tp = _wall(plain, piv)
        eb, ep = _recon_err(Lb, piv, W), _recon_err(Lp, piv, W)
        print(f"diag {name} prec={precision} level={lvl} B={1 << lvl} "
              f"F={F} W={W} blocked_ms={tb * 1e3:.3f} plain_ms={tp * 1e3:.3f}"
              f" err_blocked={eb:.2e} err_plain={ep:.2e}", flush=True)
        assert eb <= DIAG_TOL[precision] and ep <= DIAG_TOL[precision]
        del piv, Lb, Lp


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_df_residual_on_card(card, name):
    """df_matvec and df_matvec_multi agree with the f64 CSR matvec to
    1e-13 relative on the card — the accuracy the refinement loop needs —
    which fails if the compiler contracts Dekker's split into an FMA."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse

    from cholesky_tpu.io import mmio
    from cholesky_tpu.numeric import refine
    from cholesky_tpu.utils.laplacian import grid_laplacian

    n, r, c, v = grid_laplacian(PROBLEMS[name][0])
    r, c, v = mmio.symmetrize_coo(r, c, v)
    a = scipy.sparse.csr_matrix((v, (r, c)), shape=(n, n))
    idx, ah, al = refine.build_ell(n, r, c, v)
    idx_d, ah_d, al_d = (jnp.asarray(t) for t in (idx, ah, al))
    a64_d = ah_d.astype(jnp.float64) + al_d.astype(jnp.float64)
    rng = np.random.default_rng(0)
    k = 4
    x64 = rng.standard_normal((n, k))
    xh, xl = refine.split_f64(x64)
    z = np.zeros((1, k), np.float32)
    xh_d = jnp.asarray(np.concatenate([xh, z]))
    xl_d = jnp.asarray(np.concatenate([xl, z]))
    xe64 = jnp.asarray(np.concatenate([x64, np.zeros((1, k))]))
    yref = a @ x64

    def rel(y):
        return float(np.max(np.abs(y - yref)) / np.max(np.abs(yref)))

    df1 = jax.jit(refine.df_matvec)
    dfk = jax.jit(refine.df_matvec_multi)
    f64_1 = jax.jit(lambda i, a_, x: jnp.sum(a_ * x[i], axis=1))
    f64_k = jax.jit(lambda i, a_, x: jnp.sum(a_[:, :, None] * x[i], axis=1))
    (yh, yl), t_df1 = _wall(df1, idx_d, ah_d, al_d, xh_d[:, 0], xl_d[:, 0])
    y1 = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    e_df1 = float(np.max(np.abs(y1 - yref[:, 0]))
                  / np.max(np.abs(yref[:, 0])))
    (yhk, ylk), t_dfk = _wall(dfk, idx_d, ah_d, al_d, xh_d, xl_d)
    e_dfk = rel(np.asarray(yhk, np.float64) + np.asarray(ylk, np.float64))
    y64, t_f64_1 = _wall(f64_1, idx_d, a64_d, xe64[:, 0])
    y64k, t_f64_k = _wall(f64_k, idx_d, a64_d, xe64)
    e_f64k = rel(np.asarray(y64k))
    print(f"df {name} n={n} K={idx.shape[1]} df_err={e_df1:.2e} "
          f"df_multi_err={e_dfk:.2e} f64_multi_err={e_f64k:.2e} "
          f"df_ms={t_df1 * 1e3:.3f} f64_ms={t_f64_1 * 1e3:.3f} "
          f"df_multi{k}_ms={t_dfk * 1e3:.3f} f64_multi{k}_ms="
          f"{t_f64_k * 1e3:.3f}", flush=True)
    assert e_df1 <= 1e-13 and e_dfk <= 1e-13
    assert np.asarray(y64).shape == (n,)
