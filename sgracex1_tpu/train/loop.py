"""Training loops: node classification (Planetoid-style full graph) and
graph classification (molecule batches).

Mirrors the reference's training drivers: Adam with the qbits-dependent
learning-rate rule (demo_sgrace.py:433-443), cross-entropy loss, per-epoch
accuracy tracking, best-model checkpointing (demo_sgrace.py:595-610). All
steps are jitted; the graph stays device-resident across epochs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgracex1_tpu.config import SGRACEConfig
from sgracex1_tpu.graph.batch import GraphBatch
from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.datasets import NodeClassificationData
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.nn.module import TrainState
from sgracex1_tpu.ops.dispatch import PreparedAdjacency, prepare_adjacency


def _prepare_backend(A: SparseMatrix, prepare):
    """Resolve the training loops' ``prepare`` argument into the adjacency
    the jitted step consumes.

    ``prepare`` is:

    - ``"auto"`` (default): cost-model backend choice
      (ops/dispatch.prepare_adjacency);
    - a backend name (``"dense"``/``"xla"``): forced method;
    - ``"off"``/``None``/``False``: the bare SparseMatrix edge path;
    - a PreparedAdjacency: used as-is (caller controls everything).
    """
    if prepare is None or prepare is False or prepare == "off":
        return A
    if isinstance(prepare, PreparedAdjacency):
        return prepare
    method = None if prepare in (True, "auto") else prepare
    return prepare_adjacency(A, method=method or "auto")


def create_train_state(
    model, rng, init_args, learning_rate: float
) -> TrainState:
    params = model.init(rng, *init_args)
    tx = optax.adam(learning_rate)
    return TrainState.create(apply_fn=model.apply, params=params, tx=tx)


@dataclasses.dataclass
class History:
    train_acc: List[float] = dataclasses.field(default_factory=list)
    test_acc: List[float] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    best_test_acc: float = 0.0
    best_params: Optional[dict] = None
    # wall seconds of each training step, ended by block_until_ready (the
    # first one includes compilation)
    step_s: List[float] = dataclasses.field(default_factory=list)
    backend: str = ""  # aggregation backend the steps ran on


def _masked_xent(logits, y, mask):
    ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    return jnp.sum(ls * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def train_node_classifier(
    model,
    data: NodeClassificationData,
    cfg: SGRACEConfig,
    *,
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
) -> Tuple[TrainState, History]:
    """Full-graph node classification (the reference's emulation driver).

    ``prepare`` (default "auto") picks the aggregation backend — see
    _prepare_backend. The graph, features, labels and masks reach the
    jitted steps as ARGUMENTS, not closure captures: captured arrays are
    embedded in the compiled program as constants (at 2^20 nodes that made
    each program ~390 MB and added tens of seconds of compile time)."""
    A = _prepare_backend(
        sym_norm(data.edge_index, data.num_nodes).device(), prepare
    )
    x = jnp.asarray(data.x)
    y = jnp.asarray(data.y)
    masks = {
        k: jnp.asarray(getattr(data, f"{k}_mask").astype(np.float32))
        for k in ("train", "test")
    }

    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    state = create_train_state(
        model, init_rng, (A, x), cfg.resolved_learning_rate()
    )
    if cfg.preload is not None:
        # the reference's .ptx preload + very-low-LR fine-tune flow
        # (demo_sgrace.py:42,422-435; load_weights register, sgrace.py:1852)
        from sgracex1_tpu.train.checkpoint import load_checkpoint

        state = state.replace(
            params=load_checkpoint(cfg.preload, state.params)
        )

    @jax.jit
    def step(state, A, x, y, masks, dropout_rng):
        def loss_fn(params):
            logits = state.apply_fn(
                params, A, x, training=True, rngs={"dropout": dropout_rng}
            )
            return _masked_xent(logits, y, masks["train"]), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        state = state.apply_gradients(grads=grads)
        return state, loss, logits

    @jax.jit
    def evaluate(state, A, x, y, masks):
        logits = state.apply_fn(state.params, A, x, training=False)
        pred = jnp.argmax(logits, -1)
        accs = {}
        for k, m in masks.items():
            accs[k] = jnp.sum((pred == y) * m) / jnp.maximum(jnp.sum(m), 1.0)
        return accs

    hist = History(backend=getattr(A, "kind", "off"))
    for epoch in range(cfg.num_epochs):
        rng, drng = jax.random.split(rng)
        t0 = time.perf_counter()
        state, loss, _ = step(state, A, x, y, masks, drng)
        jax.block_until_ready(loss)
        hist.step_s.append(time.perf_counter() - t0)
        accs = evaluate(state, A, x, y, masks)
        tr, te = float(accs["train"]), float(accs["test"])
        hist.loss.append(float(loss))
        hist.train_acc.append(tr)
        hist.test_acc.append(te)
        if te > hist.best_test_acc:
            hist.best_test_acc = te
            hist.best_params = jax.device_get(state.params)
        if log_every and (epoch + 1) % log_every == 0:
            print(
                f"epoch {epoch + 1:03d} loss {float(loss):.4f} "
                f"train {tr:.4f} test {te:.4f}"
            )
    return state, hist


def train_node_classifier_sampled(
    model,
    data: NodeClassificationData,
    cfg: SGRACEConfig,
    *,
    batch_size: int = 128,
    fanouts=(10, 10),
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
) -> Tuple[TrainState, History]:
    """Neighbor-sampled node classification — the reference's NeighborLoader
    path for graphs beyond the full-batch limit (demo_sgrace.py:112-125).
    Fresh subgraphs are sampled every epoch; evaluation runs full-graph.

    ``prepare`` picks the backend on BOTH paths: the full graph once
    (evaluation), and each sampled batch at staging time. Batches keep one
    compiled step program via the sticky pad floors the sampler applies
    (node/edge counts).
    """
    from sgracex1_tpu.graph.sampling import make_neighbor_batches

    np_rng = np.random.default_rng(seed)
    train_nodes = np.nonzero(data.train_mask)[0]

    A_full = _prepare_backend(
        sym_norm(data.edge_index, data.num_nodes).device(), prepare
    )
    x_full = jnp.asarray(data.x)
    y_full = jnp.asarray(data.y)
    masks = {
        k: jnp.asarray(getattr(data, f"{k}_mask").astype(np.float32))
        for k in ("train", "test")
    }

    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    state = create_train_state(
        model, init_rng, (A_full, x_full), cfg.resolved_learning_rate()
    )

    @jax.jit
    def step(state, batch_A, bx, by, bm, dropout_rng):
        def loss_fn(params):
            logits = state.apply_fn(
                params, batch_A, bx, training=True,
                rngs={"dropout": dropout_rng},
            )
            return _masked_xent(logits, by, bm)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    @jax.jit
    def evaluate(state, A_full, x_full, y_full, masks):
        # arguments, not captures: see train_node_classifier
        logits = state.apply_fn(state.params, A_full, x_full, training=False)
        pred = jnp.argmax(logits, -1)
        return {
            k: jnp.sum((pred == y_full) * m) / jnp.maximum(jnp.sum(m), 1.0)
            for k, m in masks.items()
        }

    hist = History()
    n_pad = e_pad = 0  # sticky pad floors: one compiled program per run
    for epoch in range(cfg.num_epochs):
        batches = make_neighbor_batches(
            data.edge_index, data.x, data.y, train_nodes,
            batch_size=batch_size, fanouts=fanouts, rng=np_rng,
            n_pad=n_pad, e_pad=e_pad,
        )
        n_pad = max(n_pad, batches[0].x.shape[0])
        e_pad = max(e_pad, batches[0].A.e_pad)
        for b in batches:
            rng, drng = jax.random.split(rng)
            bA = _prepare_backend(b.A.device(), prepare)
            state, loss = step(
                state,
                bA,
                jnp.asarray(b.x),
                jnp.asarray(b.y),
                jnp.asarray(b.seed_mask.astype(np.float32)),
                drng,
            )
        accs = evaluate(state, A_full, x_full, y_full, masks)
        tr, te = float(accs["train"]), float(accs["test"])
        hist.loss.append(float(loss))
        hist.train_acc.append(tr)
        hist.test_acc.append(te)
        if te > hist.best_test_acc:
            hist.best_test_acc = te
            hist.best_params = jax.device_get(state.params)
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch + 1:03d} train {tr:.4f} test {te:.4f}")
    return state, hist


def train_graph_classifier(
    model,
    train_batches: Sequence[GraphBatch],
    test_batches: Sequence[GraphBatch],
    cfg: SGRACEConfig,
    *,
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
) -> Tuple[TrainState, History]:
    """Graph classification (the molecule notebook's train()/test() loops,
    Adam lr=0.01, cross-entropy — Graph_Classification.ipynb cell 20).
    Batches are static across epochs, so each batch's adjacency is
    prepared once at staging time (``prepare``, see _prepare_backend) and
    the prepared backend amortizes over every epoch."""

    def _stage(batches):
        out = []
        for b in batches:
            b = jax.device_put(b)
            out.append((_prepare_backend(b.A, prepare), b))
        return out

    dev_batches = _stage(train_batches)
    dev_test = _stage(test_batches)
    A0, b0 = dev_batches[0]

    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    lr = cfg.learning_rate if cfg.learning_rate is not None else 0.01
    state = create_train_state(
        model,
        init_rng,
        (A0, jnp.asarray(b0.x), jnp.asarray(b0.graph_ids), b0.num_graphs),
        lr,
    )

    @jax.jit
    def step(state, A, batch: GraphBatch, dropout_rng):
        def loss_fn(params):
            logits = state.apply_fn(
                params,
                A,
                batch.x,
                batch.graph_ids,
                batch.num_graphs,
                training=True,
                rngs={"dropout": dropout_rng},
            )
            return _masked_xent(
                logits, batch.y, batch.label_mask.astype(jnp.float32)
            )

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    @jax.jit
    def count_correct(state, A, batch: GraphBatch):
        logits = state.apply_fn(
            state.params,
            A,
            batch.x,
            batch.graph_ids,
            batch.num_graphs,
            training=False,
        )
        pred = jnp.argmax(logits, -1)
        m = batch.label_mask
        return jnp.sum((pred == batch.y) * m), jnp.sum(m)

    def accuracy(batches):
        c = t = 0
        for A, b in batches:
            ci, ti = count_correct(state, A, b)
            c += int(ci)
            t += int(ti)
        return c / max(t, 1)

    hist = History()
    for epoch in range(cfg.num_epochs):
        for A, b in dev_batches:
            rng, drng = jax.random.split(rng)
            state, loss = step(state, A, b, drng)
        tr, te = accuracy(dev_batches), accuracy(dev_test)
        hist.loss.append(float(loss))
        hist.train_acc.append(tr)
        hist.test_acc.append(te)
        if te > hist.best_test_acc:
            hist.best_test_acc = te
            hist.best_params = jax.device_get(state.params)
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch + 1:03d} train {tr:.4f} test {te:.4f}")
    return state, hist


# ---------------------------------------------------------------------------
# Multi-label inductive training (PPI-style — BASELINE.json config 3)
# ---------------------------------------------------------------------------


def micro_f1(pred: np.ndarray, target: np.ndarray) -> float:
    """Micro-averaged F1 over all (node, label) decisions (the PPI metric)."""
    pred = np.asarray(pred, bool)
    target = np.asarray(target, bool)
    tp = np.sum(pred & target)
    fp = np.sum(pred & ~target)
    fn = np.sum(~pred & target)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def _pad_multilabel_graph(g, n_pad: int, fill: float):
    """(A, x, y, node_mask) padded to n_pad nodes; A gets self-loops with
    ``fill`` so attention keeps the self edge (the GAT edge mask drops
    zero-valued edges, matching the reference's adj_d > 0 mask)."""
    from sgracex1_tpu.graph.normalize import sym_norm_edges

    n = g.num_nodes
    ei, ew = sym_norm_edges(g.edge_index, n, fill=fill)
    A = SparseMatrix.from_coo(
        ei[0], ei[1], ew, (n_pad, n_pad), pad_to=128, sort=False
    )
    x = np.zeros((n_pad, g.num_features), np.float32)
    x[:n] = g.x
    y = np.zeros((n_pad, g.num_labels), np.float32)
    y[:n] = g.y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    return A, x, y, mask


def train_multilabel_inductive(
    model,
    train_graphs,
    val_graphs,
    test_graphs,
    cfg: SGRACEConfig,
    *,
    fill: float = 1.0,
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
) -> Tuple[TrainState, History]:
    """Inductive multi-label node classification over whole held-out graphs
    (the PPI protocol): sigmoid BCE loss, micro-F1 metric, best model by
    val F1. All graphs are padded to one static (n_pad, e_pad) shape so a
    single compiled program serves the whole dataset; History.*_acc carries
    micro-F1. Each graph's adjacency is prepared once (``prepare``) and
    reused every epoch.
    """
    all_graphs = list(train_graphs) + list(val_graphs) + list(test_graphs)
    n_pad = max(g.num_nodes for g in all_graphs)
    n_pad = ((n_pad + 127) // 128) * 128

    # one shared e_pad across all splits -> one compiled program
    tmp = [_pad_multilabel_graph(g, n_pad, fill) for g in all_graphs]
    e_pad = max(it[0].e_pad for it in tmp)

    def prep(graphs):
        items = [_pad_multilabel_graph(g, n_pad, fill) for g in graphs]
        out = []
        for A, x, y, m in items:
            bA = _prepare_backend(
                A.pad_edges_to(e_pad).with_uniform_nnz().device(), prepare
            )
            out.append((bA, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)))
        return out

    train_b, val_b, test_b = prep(train_graphs), prep(val_graphs), prep(test_graphs)

    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    A0, x0, _, _ = train_b[0]
    state = create_train_state(
        model, init_rng, (A0, x0), cfg.resolved_learning_rate()
    )

    @jax.jit
    def step(state, A, x, y, m, dropout_rng):
        def loss_fn(params):
            logits = state.apply_fn(
                params, A, x, training=True, rngs={"dropout": dropout_rng}
            )
            ls = optax.sigmoid_binary_cross_entropy(logits, y)
            return jnp.sum(ls * m[:, None]) / jnp.maximum(
                jnp.sum(m) * y.shape[1], 1.0
            )

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    @jax.jit
    def predict(state, A, x):
        return state.apply_fn(state.params, A, x, training=False) > 0.0

    def eval_f1(batches):
        preds, targets = [], []
        for A, x, y, m in batches:
            p = np.asarray(predict(state, A, x))
            keep = np.asarray(m) > 0
            preds.append(p[keep])
            targets.append(np.asarray(y)[keep])
        return micro_f1(np.concatenate(preds), np.concatenate(targets))

    hist = History()
    for epoch in range(cfg.num_epochs):
        for A, x, y, m in train_b:
            rng, drng = jax.random.split(rng)
            state, loss = step(state, A, x, y, m, drng)
        tr, va, te = eval_f1(train_b), eval_f1(val_b), eval_f1(test_b)
        hist.loss.append(float(loss))
        hist.train_acc.append(tr)
        hist.test_acc.append(te)
        if va > hist.best_test_acc:  # model selection on val (PPI protocol)
            hist.best_test_acc = va
            hist.best_params = jax.device_get(state.params)
        if log_every and (epoch + 1) % log_every == 0:
            print(
                f"epoch {epoch + 1:03d} loss {float(loss):.4f} "
                f"train-F1 {tr:.4f} val-F1 {va:.4f} test-F1 {te:.4f}"
            )
    return state, hist
