"""chip_smoke.py's contract where there is no GPU: it refuses to run and
prints no result, and it fails outside a checkout. Its phases, called
directly, pass at a tiny size on the CPU, and its host references are
checked against the package's own."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, SCRIPT if cwd == REPO else "chip_smoke.py", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_no_gpu_fails_without_result():
    p = _run([], REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    p = _run([], str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_rehearsal_runs_every_phase(capsys):
    """The single-card phases at a tiny size; each raises on a failed check."""
    sys.path.insert(0, REPO)
    import chip_smoke

    dev = jax.devices()[0]
    data = chip_smoke.phase_gcn(1 << 12, 5, dev)
    chip_smoke.phase_gat(data, 5, dev)
    chip_smoke.phase_int8(1024, dev)
    out = capsys.readouterr().out
    for phase in ("gcn", "gat", "int8"):
        assert f"phase {phase}" in out.splitlines()
    assert "FAILED" not in out
    assert out.count(": ok (") == 9


def test_four_cards_phase_on_virtual_devices(capsys):
    """The distributed phase on four virtual CPU devices: the 4-device halo
    GCN+GAT step matches the same step on one device."""
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.phase_four_cards(1 << 12, jax.devices()[0])
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert out.count(": ok (") == 2


@pytest.mark.parametrize("heads,F", [(1, 4), (3, 2)])
def test_gat_reference_matches_package_reference(rng, heads, F):
    sys.path.insert(0, REPO)
    import chip_smoke
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.ops.sddmm import gat_attention_agg_ref
    from tests.conftest import make_random_graph

    n = 60
    A = sym_norm(make_random_graph(rng, n), n)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    W = rng.standard_normal((5, heads * F)).astype(np.float32)
    att = rng.standard_normal((2 * heads * F, 1)).astype(np.float32)
    ref = chip_smoke.gat_reference(A, x, W, att, heads, F)
    Wh = (x.astype(np.float64) @ W).reshape(n, heads, F)
    a = att.reshape(-1)
    s1 = np.einsum("nhf,hf->nh", Wh, a[: heads * F].reshape(heads, F))
    s2 = np.einsum("nhf,hf->nh", Wh, a[heads * F:].reshape(heads, F))
    out = gat_attention_agg_ref(A, jnp.asarray(s1, jnp.float32),
                                jnp.asarray(s2, jnp.float32),
                                jnp.asarray(Wh, jnp.float32))
    np.testing.assert_allclose(np.asarray(out).reshape(n, -1), ref,
                               rtol=1e-4, atol=1e-5)
    assert chip_smoke.rel_err(np.asarray(out).reshape(n, -1), ref) < 1e-4


def test_check_raises_on_failure():
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.check("fine", True, "detail")
    with pytest.raises(AssertionError, match="bad: why"):
        chip_smoke.check("bad", False, "why")
