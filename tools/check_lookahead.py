#!/usr/bin/env python
"""Inspect the COMPILED root-front programs for the depth-1 lookahead.

Complements tests/test_lookahead_hlo.py (backend-independent dependence
check on the lowered module) with a look at the post-optimization,
scheduled module:

  * on several GPUs, the XLA latency-hiding scheduler splits the lookahead
    collective into `all-reduce-start` / `all-reduce-done`; this tool
    asserts the START is scheduled BEFORE the step's big trailing dot
    and the DONE after it — the actual overlap window;
  * on the CPU virtual mesh (no async collectives) it reports the
    scheduled order of the in-body all-reduce relative to the trailing
    dot/fusion, plus the dependence check, as the best available signal.

Usage: [XLA_FLAGS=--xla_force_host_platform_device_count=8]
       python tools/check_lookahead.py [1d|2d] [F] [block]
"""
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    scheme = sys.argv[1] if len(sys.argv) > 1 else "1d"
    F = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    block = int(sys.argv[3]) if len(sys.argv) > 3 else 256

    # CHOLESKY_TPU_LOOKAHEAD_TPU=1 targets the real backend (needs >= 8
    # chips for the mesh); default is the 8-virtual-CPU-device mesh —
    # the platform choice must happen before any jax use
    if os.environ.get("CHOLESKY_TPU_LOOKAHEAD_TPU") != "1":
        import cholesky_tpu

        cholesky_tpu.force_cpu()
        import jax

        jax.config.update("jax_num_cpu_devices", 8)
    import jax
    import jax.numpy as jnp

    from cholesky_tpu.parallel import dist_cholesky as dc
    from cholesky_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    fn = (dc.distributed_cholesky if scheme == "1d"
          else dc.distributed_cholesky_2d)
    jfn = jax.jit(lambda a: fn(a, mesh, block=block))
    compiled = jfn.lower(
        jax.ShapeDtypeStruct((F, F), jnp.float32)).compile()
    txt = compiled.as_text()
    backend = jax.devices()[0].platform
    print(f"scheme={scheme} F={F} block={block} backend={backend}")

    # find the while-body computation (the one holding the loop's dots)
    bodies = re.findall(r"%?(\S*body\S*) \([^)]*\) -> .*?\{(.*?)\n\}",
                        txt, re.S)
    body = max((b for _, b in bodies), key=len, default=txt)
    lines = [ln for ln in body.splitlines() if "=" in ln]

    def idx_of(pred):
        return [i for i, ln in enumerate(lines) if pred(ln)]

    starts = idx_of(lambda ln: "all-reduce-start" in ln)
    dones = idx_of(lambda ln: "all-reduce-done" in ln)
    allred = idx_of(lambda ln: re.search(r"= \S*all-reduce", ln))
    dots = idx_of(lambda ln: ("dot(" in ln or "fusion" in ln and "dot" in ln)
                  and "convolution" not in ln)
    big = dots[-1] if dots else None
    print(f"all-reduce-start at lines {starts}; done at {dones}; "
          f"plain all-reduce at {allred}; dot/fusion lines {dots[:8]}...")
    if starts and big is not None:
        ok = any(s < big for s in starts) and any(d > big for d in dones)
        print("ASYNC OVERLAP SCHEDULED:" , "YES" if ok else "NO")
        sys.exit(0 if ok else 1)
    print("(no async collective pairs on this backend — see "
          "tests/test_lookahead_hlo.py for the dependence guarantee)")


if __name__ == "__main__":
    main()
