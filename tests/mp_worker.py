"""Worker process for tests/test_multiprocess.py.

Joins a real 2-process jax.distributed CPU cluster (gloo collectives),
runs one halo-exchange GCN layer forward + gradients over the GLOBAL
mesh (2 processes x 2 local devices = 4 shards), reshards the results to
fully-replicated, and process 0 writes them for the parent to compare
against the single-process reference. This exercises init_multihost and
the actual multi-process code path — the one thing the virtual
single-process mesh cannot (SURVEY §5 "jax.distributed init + GSPMD
mesh")."""

import sys

import numpy as np


def main() -> None:
    pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import jax

    # the workers run on the CPU whatever accelerator the host has
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from sgracex1_tpu.parallel.mesh import global_mesh, init_multihost

    init_multihost(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.parallel.halo import build_halo, dist_gnn_layer_halo
    from sgracex1_tpu.parallel.partition import pad_nodes

    # both processes build the identical global problem (seeded)
    rng = np.random.default_rng(0)
    n, f, h = 96, 12, 8
    m = n * 6
    ei = np.unique(
        np.stack([rng.integers(0, n, m), rng.integers(0, n, m)]), axis=1
    )
    A = sym_norm(ei, n)
    mesh = global_mesh()
    n_dev = mesh.devices.size
    assert n_dev == 4, n_dev
    G, n_pad = build_halo(A, n_dev)

    X = rng.standard_normal((n, f)).astype(np.float32)
    W = jnp.asarray(rng.standard_normal((f, h)).astype(np.float32) * 0.3)

    sh = NamedSharding(mesh, P("graph"))

    def shard(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, sh, lambda idx: a[idx]
        )

    X_d = shard(pad_nodes(X, n_pad))
    G_d = jax.tree.map(shard, G)

    # multi-process arrays must be ARGUMENTS, not closure captures
    out = jax.jit(
        lambda Gv, xv, Wv: dist_gnn_layer_halo(mesh, Gv, xv, Wv, relu=True)
    )(G_d, X_d, W)

    def loss(Gv, xv, Wv):
        return jnp.sum(
            dist_gnn_layer_halo(mesh, Gv, xv, Wv, relu=True) ** 2
        )

    gx, gW = jax.jit(jax.grad(loss, argnums=(1, 2)))(G_d, X_d, W)

    # reshard to fully-replicated (a real cross-process collective) so
    # every process holds the complete arrays
    rep = jax.jit(
        lambda t: t,
        out_shardings=NamedSharding(mesh, P()),
    )((out, gx, gW))
    out_r, gx_r, gW_r = jax.tree.map(np.asarray, rep)
    if pid == 0:
        np.savez(out_path, out=out_r, gx=gx_r, gW=gW_r, n=n, n_pad=n_pad)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
