"""Multi-host runtime validated for real: two OS processes form a JAX
distributed cluster over localhost (CPU backend, 1 device each), build a
global 2-device mesh, and reduce across HOSTS — the jax.distributed
bring-up that `parallel/multihost.py::initialize` wraps (SURVEY §2.3
"Elasticity / multi-node"). No multi-machine cluster required."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow  # real 2-process clusters, minutes each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.environ["MGR_REPO"])
    import jax
    jax.config.update("jax_platforms", "cpu")

    from mgr_tpu.parallel import multihost

    pid = int(os.environ["MGR_PID"])
    multihost.initialize(
        coordinator_address=os.environ["MGR_COORD"],
        num_processes=2,
        process_id=pid,
    )
    info = multihost.process_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 2, info
    assert multihost.is_primary() == (pid == 0)

    # Cross-host reduction over a global mesh: each host contributes
    # its (pid + 1) and both must see the global sum 3.
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((2,), ("data",))
    local = jnp.full((1,), float(pid + 1))
    global_arr = jax.make_array_from_process_local_data(
        jax.NamedSharding(mesh, P("data")), local, global_shape=(2,)
    )
    total = jax.jit(
        jnp.sum, out_shardings=jax.NamedSharding(mesh, P())
    )(global_arr)
    assert float(total) == 3.0, float(total)
    print(f"worker {pid} ok")
""")


def test_two_process_cluster_psum(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    procs = []
    for pid in (0, 1):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({
            "MGR_REPO": REPO, "MGR_PID": str(pid), "MGR_COORD": coord,
            "JAX_PLATFORMS": "cpu",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = [p.communicate(timeout=300) for p in procs]
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid}:\n{err[-2000:]}"
        assert f"worker {pid} ok" in out


FIT_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.environ["MGR_REPO"])
    import jax
    jax.config.update("jax_platforms", "cpu")

    from mgr_tpu.parallel import multihost

    pid = int(os.environ["MGR_PID"])
    multihost.initialize(
        coordinator_address=os.environ["MGR_COORD"],
        num_processes=2,
        process_id=pid,
    )

    from mgr_tpu.core import config as cfglib
    from mgr_tpu.data import datasets, synthetic
    from mgr_tpu.models import build_model
    from mgr_tpu.train.loop import fit

    # Identical corpus on both hosts (same seed -> same files/split).
    root = os.environ["MGR_ROOT"]
    if pid == 0:
        os.makedirs(root, exist_ok=True)
        synthetic.make_skeletal_dataset(root, n_files=10,
                                        frames_per_label=8, seed=7)
        open(os.path.join(root, ".ready"), "w").close()
    else:
        import time
        for _ in range(600):
            if os.path.exists(os.path.join(root, ".ready")):
                break
            time.sleep(0.1)

    enc = cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.0,
                               dropout=(0.0, 0.0), output_dropout=0.0)
    cfg = cfglib.get_preset("skeletal").replace(
        maxlen=24, batch_size=4, compute_dtype="float32", encoder=enc,
        optimizer=cfglib.OptimizerConfig(learning_rate=3e-3),
        patience=100,
    )
    ds = datasets.build_skeletal_dataset(
        os.path.join(root, "Training_set_skeletal.csv"),
        os.path.join(root, "training.csv"), cfg,
    )
    mesh = jax.make_mesh((2,), ("data",))  # spans both processes
    model = build_model(cfg)
    res = fit(model, ds, workdir=None, mesh=mesh, epochs=3)
    print(f"worker {pid} fit loss={res.history[-1]['train_loss']:.6f} "
          f"first={res.history[0]['train_loss']:.6f}")
""")


def test_two_process_fit_dp(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    procs = []
    for pid in (0, 1):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({
            "MGR_REPO": REPO, "MGR_PID": str(pid), "MGR_COORD": coord,
            "MGR_ROOT": str(tmp_path / "corpus"),
            "JAX_PLATFORMS": "cpu",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", FIT_WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = [p.communicate(timeout=540) for p in procs]
    losses = []
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid}:\n{err[-2500:]}"
        line = [l for l in out.splitlines() if "fit loss=" in l][0]
        final = float(line.split("loss=")[1].split()[0])
        first = float(line.split("first=")[1])
        losses.append((first, final))
    # Both hosts observe the identical (global, replicated) loss and it
    # improved over 3 epochs.
    assert losses[0] == losses[1], losses
    assert losses[0][1] < losses[0][0], losses
