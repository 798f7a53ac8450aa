"""Multi-process communication backend smoke test (SURVEY.md §5 A8).

Spawns two real OS processes, each with 4 virtual CPU devices, brings up
`jax.distributed` (`parallel.mesh.initialize_distributed`) across them, and
runs a cross-process pjit reduction over the global 8-device mesh — the
CPU-simulated stand-in for a 2-host cluster. The reference has no
distributed backend at all (single GPU, cudaSetDevice(0) everywhere).
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    sys.path.insert(0, %(repo)r)
    from cpp_cuda_raytracer_dev_tpu.parallel.mesh import (
        RAYS_AXIS, initialize_distributed, make_mesh)

    coord, pid = sys.argv[1], int(sys.argv[2])
    initialize_distributed(coord, num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(RAYS_AXIS))
    data = np.arange(32, dtype=np.float32).reshape(8, 4)
    arr = jax.make_array_from_callback((8, 4), sh, lambda idx: data[idx])
    total = jax.jit(jnp.sum,
                    out_shardings=NamedSharding(mesh, P()))(arr)
    val = float(total)            # replicated => addressable everywhere
    assert val == float(data.sum()), val
    print(f"proc {pid}: OK sum={val}")
""")


def test_two_process_distributed_psum(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER % {"repo": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))})

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i}: OK" in out, out
