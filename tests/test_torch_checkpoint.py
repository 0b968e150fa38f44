"""The port's checkpoint io (``repro_torch.checkpoint.io``) in the
reference's file format: save -> load bit for bit for every dtype a round
carry holds, files that pass between the two packages in both directions,
the refusals (dtype, leaf count), the atomic save, and the fused driver's
carry for dense f32, dense bf16 with rollback, and the compressed cohort
with int8 slots, whose index (keys, dtypes, shapes) equals the one the
reference writes for the same configuration
(tests/test_checkpoint_roundtrip.py)."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import io as ref_io  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402

DTYPES = ["float32", "bfloat16", "int8", "int32", "bool"]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int8": torch.int8, "int32": torch.int32, "bool": torch.bool}


def _sample(dtype: str, shape, seed: int) -> np.ndarray:
    """numpy planes of ``dtype`` (bf16 through jnp's ml_dtypes), with a NaN
    in the float planes so their payload bits are compared too."""
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal(shape).astype(np.float32) * 10.0
    if dtype == "bool":
        return raw > 0
    if dtype in ("int8", "int32"):
        return raw.astype(np.dtype(dtype))
    a = raw.astype(jnp.dtype(dtype))
    a.flat[0] = np.float32(np.nan).astype(a.dtype)
    return a


def _bits(a) -> np.ndarray:
    """The bit pattern of a numpy array or a torch tensor (NaN == NaN,
    -0.0 != +0.0)."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    a = np.ascontiguousarray(a)
    return np.frombuffer(a.tobytes(), np.uint8)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A numpy plane as a torch tensor with the same bits."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_round_trip_bit_identical(tmp_path, dtype):
    """A tree of planes (2-d, 1-d, a scalar and an empty plane) survives
    save -> load bit for bit, its dtypes and shapes too."""
    tree = {"a": _to_torch(_sample(dtype, (5, 3), 1), dtype),
            "b": {"c": _to_torch(_sample(dtype, (7,), 2), dtype)},
            "s": torch.tensor(3, dtype=torch.int32),
            "z": torch.empty((0, 4), dtype=TORCH[dtype])}
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, tree, step=4, extra={"tag": "x"})
    out, step, extra = tio.load_checkpoint(path, tree)
    assert step == 4 and extra == {"tag": "x"}
    for got, want in ((out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
                      (out["s"], tree["s"]), (out["z"], tree["z"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_files_pass_between_the_packages(tmp_path, dtype):
    """The reference reads the port's file and the port the reference's,
    bit for bit, with the same index: leaf keys, dtype names, shapes."""
    a, b = _sample(dtype, (4, 6), 3), _sample(dtype, (6,), 4)
    ref_tree = {"p": {"w": a, "b": b}, "t": np.int32(7)}
    port_tree = {"p": {"w": _to_torch(a, dtype), "b": _to_torch(b, dtype)},
                 "t": torch.tensor(7, dtype=torch.int32)}
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "p.npz")
    ref_io.save_checkpoint(ref_path, ref_tree, step=2, extra={"k": [1.5]})
    tio.save_checkpoint(port_path, port_tree, step=2, extra={"k": [1.5]})
    indexes = [json.loads(str(np.load(p)["__index__"]))
               for p in (ref_path, port_path)]
    assert indexes[0] == indexes[1]
    out, step, extra = tio.load_checkpoint(ref_path, port_tree)
    assert (step, extra) == (2, {"k": [1.5]})
    for got, want in ((out["p"]["w"], a), (out["p"]["b"], b)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    back, _, _ = ref_io.load_checkpoint(port_path, ref_tree)
    for got, want in ((back["p"]["w"], a), (back["p"]["b"], b)):
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(_bits(np.asarray(got)), _bits(want))
    assert int(back["t"]) == 7


def test_dtype_mismatch_refuses(tmp_path):
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, {"p": torch.zeros(3)})
    with pytest.raises(ValueError, match="refusing a silent cast"):
        tio.load_checkpoint(path, {"p": torch.zeros(3,
                                                    dtype=torch.bfloat16)})


def test_leaf_count_mismatch_refuses(tmp_path):
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, {"p": torch.zeros(3)})
    with pytest.raises(ValueError, match="carry layout"):
        tio.load_checkpoint(path, {"p": torch.zeros(3), "q": torch.zeros(3)})


def test_atomic_save_leaves_no_temp_files(tmp_path):
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, {"p": torch.zeros(3)})
    tio.save_checkpoint(path, {"p": torch.ones(3)})          # overwrite
    assert os.listdir(tmp_path) == ["t.npz"]
    out, _, _ = tio.load_checkpoint(path, {"p": torch.zeros(3)})
    assert torch.equal(out["p"], torch.ones(3))


# ---------------------------------------------------------------------------
# the round carry of the fused driver
# ---------------------------------------------------------------------------

K = 8
CARRY_CFGS = {
    "dense_f32": (dict(), {"float32", "int32", "bool"}),
    "dense_bf16_rollback": (dict(pending_dtype="bfloat16",
                                 divergence_factor=4.0),
                            {"bfloat16", "int32", "bool", "float32"}),
    "cohort_topk_int8": (dict(cohort_size=4, compress="topk",
                              compress_ratio=0.25, slot_dtype="int8"),
                         {"int8", "int32", "bool", "float32"}),
}


@pytest.fixture(scope="module")
def data():
    from repro.data.partition import partition_noniid
    from repro.data.synthetic import make_mnist_like
    x, y, _, _ = make_mnist_like(n_train=1200, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _drivers(data, kw):
    """The reference's and the port's FusedPAOTA, transmit='delta', on the
    same federation and initial weights (the port on its own counter
    draws: only the carry's layout is compared across packages)."""
    from repro.core import ChannelConfig, SchedulerConfig
    from repro.data.pipeline import build_federation
    from repro.fl import FLClient, FusedPAOTA, PAOTAConfig
    from repro.models.mlp import init_mlp_params, mlp_loss
    import repro_torch.core as tcore
    import repro_torch.fl as tfl
    from repro_torch.data.pipeline import build_federation as tbuild
    from repro_torch.models.mlp import mlp_loss as tloss
    from repro_torch.models.mlp import params_from_jax
    x, y, parts = data
    params = init_mlp_params(jax.random.PRNGKey(0))
    ref = FusedPAOTA(params, [FLClient(d, mlp_loss, batch_size=32, lr=0.1,
                                       local_steps=2)
                              for d in build_federation(x, y, parts)],
                     ChannelConfig(), SchedulerConfig(n_clients=K, seed=1),
                     PAOTAConfig(transmit="delta"), **kw)
    port = tfl.FusedPAOTA(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                        device="cpu"),
        [tfl.FLClient(d, tloss, batch_size=32, lr=0.1, local_steps=2)
         for d in tbuild(x, y, parts)],
        tcore.ChannelConfig(), tcore.SchedulerConfig(n_clients=K, seed=1),
        tfl.PAOTAConfig(transmit="delta"), device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("cfg", sorted(CARRY_CFGS))
def test_round_carry_round_trip_bit_identical(tmp_path, data, cfg):
    """The port's carry after 2 rounds saves and restores bit for bit, and
    its index (keys, dtypes, shapes) is the one the reference writes for
    the same configuration, so either package restores the other's."""
    kw, families = CARRY_CFGS[cfg]
    ref, port = _drivers(data, kw)
    ref.advance(2)
    port.advance(2)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "p.npz")
    ref.save_checkpoint(ref_path)
    port.save_checkpoint(port_path)
    ref_index, port_index = (
        {k: v for k, v in json.loads(str(np.load(p)["__index__"])).items()
         if k != "extra"} for p in (ref_path, port_path))
    assert port_index == ref_index
    assert families <= set(port_index["dtypes"])
    template = port._carry_record(port._carry)
    leaves = tio._flatten(template)
    out, step, extra = tio.load_checkpoint(port_path, template)
    assert step == 2 and len(extra["history"]) == 2
    got = tio._flatten(out)
    assert [k for k, _ in got] == [k for k, _ in leaves]
    for (_, g), (_, w) in zip(got, leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
