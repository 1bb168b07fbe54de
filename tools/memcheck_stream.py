"""AOT-compile each STREAMED level program for a problem and print its
HLO-temp / argument / output sizes — pinpoints which level transition
overflows HBM without executing anything.

Usage: python tools/memcheck_stream.py [shape] [levels]
Env: CHOLESKY_TPU_UPDATE_DTYPE, CHOLESKY_TPU_EXTADD as in production.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cholesky_tpu  # noqa: E402

cholesky_tpu.setup_compilation_cache()

from cholesky_tpu.numeric import frontal  # noqa: E402
from cholesky_tpu.symbolic.plan import build_plan  # noqa: E402
from cholesky_tpu.utils.laplacian import generate_problem  # noqa: E402

shape = tuple(int(x) for x in
              (sys.argv[1] if len(sys.argv) > 1 else "100,100,100").split(","))
levels = int(sys.argv[2]) if len(sys.argv) > 2 else 13
extadd = os.environ.get("CHOLESKY_TPU_EXTADD", "hybrid3")

n, r, c, v, o, cl, b = generate_problem(shape, levels)
plan = build_plan(o, cl)
fp = frontal.build_frontal_plan(plan, r, c)
total = sum((1 << l) * fp.F[l] * fp.W[l] * 4 for l in range(fp.levels))
gm_cap = frontal._effective_gathermm_cap(total)
print(f"n={n} levels={fp.levels} fronts={total/2**30:.2f} GiB "
      f"gm_cap={gm_cap/2**30:.2f} GiB update_dtype=per-level auto "
      "(mirrors frontal_factor_streamed)", flush=True)

GiB = 1 << 30
# store dtype: mirror factor()'s dispatcher — bf16 compressed factor past
# the f32-store ceiling (or when host-streamed), else native f32
store_dtype = (jnp.bfloat16 if total > frontal._F32_STORE_BYTES
               or os.environ.get("CHOLESKY_TPU_UPLOAD_STREAM") == "1"
               else None)
print(f"store_dtype={jnp.dtype(store_dtype).name if store_dtype else 'native'}",
      flush=True)
u_shape = None            # (shape, dtype) of the inter-level update operand
utag = "none"
for lvl in range(fp.levels - 1, -1, -1):
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    B = 1 << lvl
    # per-level EMIT dtype, as frontal_factor_streamed picks it
    update_dtype = frontal._update_dtype_for(jnp.float32,
                                             frontal._u_bytes(fp, lvl))
    fn = frontal._level_step_jit(fp, lvl, utag, extadd, gm_cap, update_dtype,
                                 None, True, store_dtype=store_dtype)
    piv_spec = jax.ShapeDtypeStruct((B, Fl, Wl), jnp.float32)
    args = (piv_spec,) if utag == "none" else (
        piv_spec, jax.ShapeDtypeStruct(*u_shape))
    only = os.environ.get("MEMCHECK_LVL")
    if only is not None and lvl != int(only):
        if lvl == 0:
            break
        K = Fl - Wl
        if utag == "none" and Fl > Wl:
            utag = "xxt"
            u_shape = ((B, K, Wl), update_dtype)
        else:
            utag = "arr"
            u_shape = ((B, K, K) if K else (B, 0, 0), update_dtype)
        continue
    try:
        comp = fn.lower(*args).compile()
        ma = comp.memory_analysis()
        tmp = ma.temp_size_in_bytes / GiB
        arg = ma.argument_size_in_bytes / GiB
        out = ma.output_size_in_bytes / GiB
        alias = ma.alias_size_in_bytes / GiB
        peak = getattr(ma, "peak_memory_in_bytes", 0) / GiB
        print(f"lvl{lvl:2d} utag={utag:4s} B={B:5d} F={Fl:6d} W={Wl:6d} "
              f"args={arg:6.2f} out={out:6.2f} alias={alias:6.2f} "
              f"TEMP={tmp:6.2f} PEAK={peak:6.2f} GiB", flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"lvl{lvl:2d} utag={utag:4s} B={B:5d} F={Fl:6d} W={Wl:6d} "
              f"COMPILE FAILED: {type(e).__name__}: {str(e)[:300]}",
              flush=True)
        comp = None
    # next utag/u_shape mirror frontal_factor_streamed
    if lvl == 0:
        break
    K = Fl - Wl
    if utag == "none" and Fl > Wl:
        utag = "xxt"
        u_shape = ((B, K, Wl), update_dtype)
    else:
        utag = "arr"
        u_shape = ((B, K, K) if K else (B, 0, 0), update_dtype)
