"""Multi-device GNN training with halo (boundary) exchange.

The user-facing version of the driver's dry-run: a full GAT+GCN training
step sharded over a 1D 'graph' device mesh — layer 1 is a halo-exchange
GAT, layer 2 a halo-exchange GCN, parameters replicated, graph rows and
node arrays sharded. On a CPU with XLA_FLAGS=--xla_force_host_platform_
device_count=8 this runs on 8 virtual devices; on a multi-GPU host the
same code runs over NVLink, and after `init_multihost()` across hosts.

Usage: python examples/distributed_training.py [--devices 8] [--epochs 30]
"""

import argparse
import os
import sys

if __name__ == "__main__" and "--devices" in sys.argv:
    n = sys.argv[sys.argv.index("--devices") + 1]
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from sgracex1_tpu.graph.datasets import sbm_node_classification
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.parallel.halo import (
    build_halo,
    dist_gat_layer_halo,
    dist_gnn_layer_halo,
)
from sgracex1_tpu.parallel.mesh import make_mesh
from sgracex1_tpu.parallel.partition import pad_nodes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--nheads", type=int, default=2)
    args = ap.parse_args()

    n_dev = args.devices or jax.device_count()
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} x {jax.devices()[0].platform}")

    data = sbm_node_classification(n=1024, num_classes=4, seed=0)
    A = sym_norm(data.edge_index, data.num_nodes)
    G, n_pad = build_halo(A, n_dev)
    print(
        f"N={data.num_nodes} (pad {n_pad}), halo rows/shard: "
        f"{G.n_shards * G.halo_len} vs all-gather {n_pad}"
    )

    sh = NamedSharding(mesh, P("graph"))
    x = jax.device_put(pad_nodes(data.x, n_pad), sh)
    y = jax.device_put(pad_nodes(data.y.astype(np.int32), n_pad), sh)
    masks = {
        k: jax.device_put(
            pad_nodes(
                getattr(data, f"{k}_mask").astype(np.float32), n_pad
            ),
            sh,
        )
        for k in ("train", "test")
    }
    G = jax.device_put(G, sh)

    f, h, c, H = data.num_features, args.hidden, data.num_classes, args.nheads
    rng = np.random.default_rng(0)
    init = lambda *s: jnp.asarray(
        rng.standard_normal(s).astype(np.float32) * (2.0 / s[0]) ** 0.5
    )
    params = {
        "W1": init(f, h * H),
        "att1": init(2 * h * H, 1),
        "W2": init(h * H, h),
        "Wo": init(h, c),
    }
    opt = optax.adam(0.01)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state):
        def loss_fn(p):
            hdn = dist_gat_layer_halo(
                mesh, G, x, p["W1"], p["att1"], relu=True, nheads=H
            )
            hdn = dist_gnn_layer_halo(mesh, G, hdn, p["W2"], relu=True)
            logits = hdn @ p["Wo"]
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.sum(ls * masks["train"]) / jnp.sum(masks["train"])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def evaluate(params):
        hdn = dist_gat_layer_halo(
            mesh, G, x, params["W1"], params["att1"], relu=True, nheads=H
        )
        hdn = dist_gnn_layer_halo(mesh, G, hdn, params["W2"], relu=True)
        pred = jnp.argmax(hdn @ params["Wo"], -1)
        m = masks["test"]
        return jnp.sum((pred == y) * m) / jnp.sum(m)

    for epoch in range(args.epochs):
        params, opt_state, loss = train_step(params, opt_state)
        if (epoch + 1) % 10 == 0 or epoch == 0:
            print(
                f"epoch {epoch + 1:03d} loss {float(loss):.4f} "
                f"test acc {float(evaluate(params)):.4f}"
            )


if __name__ == "__main__":
    main()
