"""End-to-end training tests — the framework's accuracy anchors.

The reference's anchors (SURVEY.md §4.4): molecule GCN 0.76 by ~epoch 36;
Cora emulation ~0.86 (8-bit) / ~0.81 (1-bit). Real datasets aren't vendored,
so CI uses synthetic analogues with the same task structure; the real-dataset
anchors run in examples/ when data is present.
"""

import numpy as np
import pytest

from sgracex1_tpu.config import SGRACEConfig
from sgracex1_tpu.graph.batch import make_batches
from sgracex1_tpu.graph.datasets import sbm_node_classification, synthetic_molecules
from sgracex1_tpu.nn.models import GCNModel, GATModel, MoleculeGCN
from sgracex1_tpu.quant.calibration import CalibrationTable
from sgracex1_tpu.train.loop import (
    train_node_classifier,
    train_node_classifier_sampled,
    train_graph_classifier,
)
from sgracex1_tpu.train.checkpoint import save_checkpoint, load_checkpoint


def test_gcn_node_classification_learns():
    data = sbm_node_classification(n=300, num_classes=3, seed=1)
    cfg = SGRACEConfig(hidden_channels=16, num_epochs=40, learning_rate=0.01)
    model = GCNModel(
        num_features=data.num_features,
        hidden_channels=16,
        num_classes=data.num_classes,
    )
    _, hist = train_node_classifier(model, data, cfg)
    assert hist.best_test_acc > 0.85, hist.best_test_acc


def test_gat_node_classification_learns():
    data = sbm_node_classification(n=300, num_classes=3, seed=2)
    cfg = SGRACEConfig(hidden_channels=16, num_epochs=40, learning_rate=0.01)
    model = GATModel(
        num_features=data.num_features,
        hidden_channels=16,
        num_classes=data.num_classes,
    )
    _, hist = train_node_classifier(model, data, cfg)
    assert hist.best_test_acc > 0.85, hist.best_test_acc


@pytest.mark.parametrize("qbits", [8, 1])
def test_quantized_training_learns(qbits):
    """QAT analogue of the Cora 8-bit/1-bit anchors: quantized training must
    still learn (1-bit with the reference's high-LR rule)."""
    data = sbm_node_classification(n=300, num_classes=3, seed=3)
    cal = CalibrationTable.for_qbits(qbits)
    cfg = SGRACEConfig(
        hidden_channels=16, num_epochs=60, w_qbits=qbits, fake_quantization=True
    )
    model = GCNModel(
        num_features=data.num_features,
        hidden_channels=16,
        num_classes=data.num_classes,
        calibration=cal,
    )
    _, hist = train_node_classifier(model, data, cfg)
    floor = 0.80 if qbits == 8 else 0.60
    assert hist.best_test_acc > floor, hist.best_test_acc


def test_quantized_gap_8bit_vs_1bit_pinned():
    """Pin the 8-bit-vs-1-bit accuracy DELTA, not just per-qbits floors: the
    reference's Cora result is ~0.86 (8-bit) vs ~0.81 (1-bit), a ~5-point
    gap (demo/README.md:133-135). On the SBM anchor (where both bit-widths
    train stably — measured 1.000/1.000 seed 3, 0.983/0.983 seed 7) a
    1-bit-datapath regression (wrong binarization sign, broken deq_o scale,
    adjacency grid collapse) shows up as a blown gap long before the 0.60
    floor above trips."""
    accs = {}
    for qbits in (8, 1):
        data = sbm_node_classification(n=300, num_classes=3, seed=7)
        cal = CalibrationTable.for_qbits(qbits)
        cfg = SGRACEConfig(
            hidden_channels=16, num_epochs=60, w_qbits=qbits,
            fake_quantization=True,
        )
        model = GCNModel(
            num_features=data.num_features,
            hidden_channels=16,
            num_classes=data.num_classes,
            calibration=cal,
        )
        _, hist = train_node_classifier(model, data, cfg)
        accs[qbits] = hist.best_test_acc
    assert accs[8] >= 0.90, accs  # ~0.86-like headroom on the easy anchor
    # the reference's ~5-point 1-bit delta
    assert accs[1] >= accs[8] - 0.05, accs


def test_molecule_graph_classification_anchor():
    """Synthetic analogue of the MUTAG anchor: 0.76 test accuracy within
    ~36 epochs (README.md:127-129)."""
    graphs = synthetic_molecules(num_graphs=150, seed=4)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(graphs))
    train = [graphs[i] for i in idx[:120]]
    test = [graphs[i] for i in idx[120:]]
    train_b = make_batches(train, 32, rng=rng, pad_to=64)
    test_b = make_batches(test, 32, pad_to=64)
    cfg = SGRACEConfig(num_epochs=36, learning_rate=0.01)
    model = MoleculeGCN(num_features=7, hidden_channels=64, num_classes=2)
    _, hist = train_graph_classifier(model, train_b, test_b, cfg)
    assert hist.best_test_acc >= 0.76, hist.best_test_acc


def test_remat_model_matches(rng_seed=0):
    """remat=True must not change outputs or gradients."""
    import jax
    import jax.numpy as jnp
    from sgracex1_tpu.graph.normalize import sym_norm

    data = sbm_node_classification(n=100, num_classes=2, seed=9)
    A = sym_norm(data.edge_index, data.num_nodes)
    x = np.asarray(data.x)
    kw = dict(
        num_features=data.num_features, hidden_channels=8, num_classes=2
    )
    m0 = GCNModel(**kw)
    m1 = GCNModel(**kw, remat=True)
    params = m0.init(jax.random.PRNGKey(0), A, jnp.asarray(x))

    def loss(m, p):
        return jnp.sum(m.apply(p, A, jnp.asarray(x)) ** 2)

    l0, g0 = jax.value_and_grad(lambda p: loss(m0, p))(params)
    l1, g1 = jax.value_and_grad(lambda p: loss(m1, p))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)


def test_train_state_checkpoint_roundtrip(tmp_path):
    """Full train-state (params + optimizer state) checkpoint round trip
    (numpy archive of the flattened tree; orbax is no longer used)."""
    import jax

    data = sbm_node_classification(n=100, num_classes=2, seed=10)
    cfg = SGRACEConfig(hidden_channels=8, num_epochs=3, learning_rate=0.01)
    model = GCNModel(
        num_features=data.num_features, hidden_channels=8, num_classes=2
    )
    state, _ = train_node_classifier(model, data, cfg)
    tree = {"params": state.params, "opt_state": state.opt_state}
    save_checkpoint(str(tmp_path / "ckpt" / "step_3.npz"), tree)
    restored = load_checkpoint(
        str(tmp_path / "ckpt" / "step_3.npz"), jax.device_get(tree)
    )
    for a, b in zip(
        jax.tree.leaves(jax.device_get(tree)),
        jax.tree.leaves(restored),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_preload_finetune_improves(tmp_path):
    """Reference .ptx preload flow (demo_sgrace.py:42,422-435): load a
    pretrained checkpoint via ``cfg.preload``, fine-tune at the automatic
    very-low LR (1e-4), and accuracy must start at the pretrained level and
    never collapse."""
    data = sbm_node_classification(n=300, num_classes=3, seed=6)
    model = GCNModel(
        num_features=data.num_features, hidden_channels=16, num_classes=3
    )
    pre_cfg = SGRACEConfig(hidden_channels=16, num_epochs=30,
                           learning_rate=0.01)
    _, pre_hist = train_node_classifier(model, data, pre_cfg)
    ckpt = str(tmp_path / "pretrained.msgpack")
    save_checkpoint(ckpt, pre_hist.best_params)

    ft_cfg = SGRACEConfig(hidden_channels=16, num_epochs=10, preload=ckpt)
    assert ft_cfg.resolved_learning_rate() == pytest.approx(0.0001)
    _, ft_hist = train_node_classifier(model, data, ft_cfg)
    # starts from the pretrained model, not from scratch: epoch-1 accuracy
    # is already at (or above) the pretrained best minus tuning noise
    assert ft_hist.test_acc[0] >= pre_hist.best_test_acc - 0.05, (
        ft_hist.test_acc[0], pre_hist.best_test_acc
    )
    # low-LR tuning must not degrade the model
    assert ft_hist.best_test_acc >= pre_hist.best_test_acc - 0.02


def test_checkpoint_roundtrip(tmp_path):
    data = sbm_node_classification(n=128, num_classes=2, seed=5)
    cfg = SGRACEConfig(hidden_channels=8, num_epochs=2, learning_rate=0.01)
    model = GCNModel(
        num_features=data.num_features, hidden_channels=8, num_classes=2
    )
    state, hist = train_node_classifier(model, data, cfg)
    p = str(tmp_path / "model.msgpack")
    save_checkpoint(p, state.params)
    restored = load_checkpoint(p, state.params)
    import jax

    leaves1 = jax.tree.leaves(jax.device_get(state.params))
    leaves2 = jax.tree.leaves(restored)
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_amazon_photo_analogue_sampled_quantized_anchor():
    """The reference's one board-hardware accuracy anchor is Amazon Photo
    via NeighborLoader at 8-bit: ~90% (demo/README.md:33). Real Amazon
    labels cannot be vendored here (gated parser: graph/datasets.load_amazon),
    so pin the analogue: an Amazon-shaped SBM (8 classes, co-purchase-like
    density, class-correlated features) trained through the SAME path —
    train_node_classifier_sampled + 8-bit fake-quant — must reach >= 0.85."""
    data = sbm_node_classification(
        n=800, num_classes=8, num_features=64, p_in=0.05, p_out=0.002,
        seed=11,
    )
    cal = CalibrationTable.for_qbits(8)
    cfg = SGRACEConfig(
        hidden_channels=16, num_epochs=20, w_qbits=8, fake_quantization=True,
        learning_rate=0.01,
    )
    model = GCNModel(
        num_features=data.num_features,
        hidden_channels=16,
        num_classes=data.num_classes,
        calibration=cal,
    )
    _, hist = train_node_classifier_sampled(
        model, data, cfg, batch_size=128, fanouts=(10, 10)
    )
    assert hist.best_test_acc >= 0.85, hist.best_test_acc


def test_training_loops_engage_prepared_backends():
    """The training loops run on the backend the cost model picks: at
    SBM-300 density the dense matmul; a forced method and the explicit
    opt-outs still work."""
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.ops.dispatch import PreparedAdjacency
    from sgracex1_tpu.train.loop import _prepare_backend

    data = sbm_node_classification(n=300, num_classes=3, seed=5)
    A = sym_norm(data.edge_index, data.num_nodes).device()

    prep = _prepare_backend(A, "auto")
    assert isinstance(prep, PreparedAdjacency)
    assert prep.kind == "dense"  # dense enough for the matmul to win
    assert _prepare_backend(A, "xla").kind == "xla"

    # explicit opt-outs still work
    assert not isinstance(_prepare_backend(A, "off"),
                          PreparedAdjacency)
    assert _prepare_backend(A, prep) is prep


def test_sampled_loop_compiles_once_across_epochs():
    """The sampled loop's jitted step must not retrace across
    batches/epochs — the sticky pads (node/edge floors) keep ONE traced
    shape. A Python-side-effect counter in the model's __call__ fires
    only at TRACE time, so its count is the number of compilations."""
    trace_count = [0]

    class CountingGCN(GCNModel):
        def __call__(self, A, x, training=False):
            trace_count[0] += 1  # trace-time only
            return super().__call__(A, x, training=training)

    data = sbm_node_classification(n=600, num_classes=4, seed=3)
    cfg = SGRACEConfig(hidden_channels=16, num_epochs=4,
                       learning_rate=0.01)
    model = CountingGCN(
        num_features=data.num_features, hidden_channels=16,
        num_classes=data.num_classes,
    )
    train_node_classifier_sampled(
        model, data, cfg, batch_size=128, fanouts=(8, 8),
        prepare="auto",
    )
    # expected traces: init (1) + train step (1) + eval (1); flax may
    # trace init twice (shape eval). Anything growing with epoch count
    # (4 epochs x ~4 batches) is a retrace bug.
    assert trace_count[0] <= 5, (
        f"sampled step retraced: {trace_count[0]} traces"
    )


def test_checkpoint_rejects_mismatched_target(tmp_path):
    import jax.numpy as jnp

    path = str(tmp_path / "p.npz")
    save_checkpoint(path, {"a": jnp.ones((2, 3)), "b": jnp.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": np.ones((3, 2)), "b": np.zeros(4)})
    with pytest.raises(ValueError, match="holds 2 arrays"):
        load_checkpoint(path, {"a": np.ones((2, 3))})
    out = load_checkpoint(path, {"a": np.ones((2, 3)), "b": np.ones(4)})
    np.testing.assert_array_equal(out["b"], np.zeros(4))


def test_history_records_step_times_and_backend():
    data = sbm_node_classification(n=120, num_classes=2, seed=3)
    cfg = SGRACEConfig(hidden_channels=8, num_epochs=3, learning_rate=0.01)
    model = GCNModel(num_features=data.num_features, hidden_channels=8,
                     num_classes=2)
    _, hist = train_node_classifier(model, data, cfg, prepare="xla")
    assert hist.backend == "xla"
    assert len(hist.step_s) == 3 and all(t > 0 for t in hist.step_s)
    _, hist = train_node_classifier(model, data, cfg, prepare="off")
    assert hist.backend == "off"
