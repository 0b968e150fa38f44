"""Port's zamba2-7b (hybrid family) serving path, CPU side, on reduced
zamba2 with 5 layers (3 shared-attention slots, the last one ragged): the
reference's params carried across with ``params_from_jax``; the attention
half of ``models/layers.py`` (RoPE, prefill attention through
``ops.swa_attention`` on both sides of the reference's flash threshold,
the MLP, decode attention on the f32 and the int8 ring); the forward's
logits and caches; the prefill -> decode hand-off (rings bit-equal) and
teacher-forced decode steps; the port's own continuity; the serve CLI;
one attention call per shared slot per prefill. Inputs come from fixed
numpy seeds; tolerance is the reference's LM tolerance. The same reduced
model runs on the card in tests/test_torch_cuda.py."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    cache_from_prefill as j_cache_from_prefill)
from repro.models.transformer import (  # noqa: E402
    init_decode_state as j_init_decode_state)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402
from repro_torch.launch.steps import prefill, serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_state, init_model, param_count)
from repro_torch.models.transformer import (  # noqa: E402
    cache_from_prefill, n_shared_slots, params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
# the reference's LM tolerance (tests/test_fused_round.py:57)
TOL = dict(rtol=1e-4, atol=1e-5)
B, T_DEC, RING = 2, 5, 128
ARCH = "zamba2-7b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**over):
    over = dict(dict(num_layers=5), **over)
    return (dataclasses.replace(j_get_reduced(ARCH), **over),
            dataclasses.replace(get_reduced(ARCH), **over))


def _pair(**over):
    jcfg, tcfg = _cfgs(**over)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu")


def _tokens(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


def _equal(got, want, what):
    assert str(got.dtype).split(".")[-1] == np.asarray(want).dtype.name, what
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def test_config_matches_reference_and_counts_6_75b_params():
    from repro.launch.steps import abstract_params
    jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(j_get_reduced(ARCH)) == \
        dataclasses.asdict(get_reduced(ARCH))
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(abstract_params(jcfg)))
    # the port's own count from shapes (no 27 GB init here)
    from repro_torch.models.ssm import _dims
    d, ff, hd = tcfg.d_model, tcfg.d_ff, tcfg.head_dim
    d_in, h, p, g, nst, d_xbc = _dims(tcfg)
    mamba = (d * (2 * d_in + 2 * g * nst + h) + tcfg.conv_kernel * d_xbc
             + 3 * h + d_in + d_in * d + d)
    shared = (d * hd * (tcfg.num_heads + 2 * tcfg.num_kv_heads)
              + tcfg.num_heads * hd * d + 3 * d * ff + 2 * d)
    assert n == (2 * tcfg.vocab_size * d + tcfg.num_layers * mamba
                 + shared + d) == 6_750_539_856
    assert n_shared_slots(tcfg) == 14 and h == 112 and nst == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    """Every leaf bit for bit, the shared block's included."""
    jcfg, tcfg, jp, model = _pair(param_dtype=dtype)
    sd = model.state_dict()
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers":
            names = [f"layers.{i}.{'.'.join(keys[1:])}"
                     for i in range(tcfg.num_layers)]
            got = torch.stack([sd[k] for k in names])
        else:
            names = [".".join(keys)]
            got = sd[names[0]]
        seen.update(names)
        assert tuple(got.shape) == leaf.shape, names[0]
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name, names[0]
        want = (leaf.view(np.uint16) if leaf.dtype.name == "bfloat16"
                else leaf)
        have = (got.view(torch.int16).numpy().view(np.uint16)
                if got.dtype == torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(have, want, err_msg=names[0])
    assert seen == set(sd)
    assert any(k.startswith("shared_attn.attn.") for k in seen)
    assert param_count(model) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(jp))


@pytest.mark.parametrize("d", [32, 112, 33])
def test_rope_rotate_matches_reference(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(B, 50, 3, d)).astype(np.float32)
    pos = np.stack([np.arange(50), np.arange(1000, 1050)]).astype(np.int32)
    got = L.rope_rotate(_t(x), _t(pos), 10000.0)
    _close(got, JL.rope_rotate(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           f"rope D={d}")
    if d % 2:
        np.testing.assert_array_equal(got[..., -1].numpy(), x[..., -1])


def _attn_params(tcfg, jp):
    return jp["shared_attn"]["attn"], {
        k: {"w": _t(v["w"])} for k, v in _np(jp["shared_attn"]["attn"]).items()}


@pytest.mark.parametrize("t", [40, 2112])
def test_apply_attention_matches_reference(t):
    """T = 2,112 is past ATTN_CHUNK_THRESHOLD: the reference takes its
    _flash scan there and its masked einsum at T = 40; the port takes
    ops.swa_attention at both. Window 64 (reduced zamba2)."""
    assert (t > JL.ATTN_CHUNK_THRESHOLD) == (t == 2112)
    jcfg, tcfg, jp, _ = _pair()
    assert tcfg.sliding_window == 64 and tcfg.causal
    jparams, tparams = _attn_params(tcfg, jp)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(B, t, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (B, t))
    jout, (jk, jv) = JL.apply_attention(jparams, jnp.asarray(x), jcfg,
                                        jnp.asarray(pos))
    for positions in (_t(pos), None):
        out, (k, v) = L.apply_attention(tparams, _t(x), tcfg, positions)
        _close(out, jout, f"attention out T={t}")
        _close(k, jk, f"k T={t}")
        _close(v, jv, f"v T={t}")


def test_causal_window_mask_and_dequantize_kv_match_reference():
    pos = np.stack([np.arange(20), np.arange(5, 25)]).astype(np.int32)
    for window in (None, 1, 7):
        _equal(L.causal_window_mask(_t(pos), _t(pos), window),
               JL.causal_window_mask(jnp.asarray(pos), jnp.asarray(pos),
                                     window), f"mask window={window}")
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (B, 6, 4, 32)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, (B, 6, 4)).astype(np.float16)
    _equal(L._dequantize_kv(_t(q), _t(scale), torch.float32),
           JL._dequantize_kv(jnp.asarray(q), jnp.asarray(scale),
                             jnp.float32), "dequantized KV")


def test_attend_positions_refuses_other_layouts():
    _, tcfg = _cfgs()
    q = torch.zeros((1, 8, 2, 32))
    for pos in (torch.arange(1, 9)[None], torch.arange(8).flip(0)[None]):
        with pytest.raises(NotImplementedError, match="arange"):
            L.attend_positions(q, q, q, tcfg, pos, pos, 64, True)
    with pytest.raises(NotImplementedError, match="prefill layout"):
        L.attend_positions(q, q[:, :4], q[:, :4], tcfg, torch.arange(8),
                           torch.arange(4), 64, True)


def test_apply_mlp_matches_reference():
    jcfg, tcfg, jp, model = _pair()
    x = np.random.default_rng(1).normal(
        size=(B, 9, tcfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(jp["shared_attn"]["mlp"], jnp.asarray(x))
    _close(L.apply_mlp(model.shared_attn.mlp, _t(x)), want, "mlp")


def _ring(cfg, seed, filled):
    """A random ring (B, S_c, Hkv, D) for one slot, zero beyond ``filled``;
    int8 payload with f16 scales under kv_quant."""
    rng = np.random.default_rng(seed)
    shape = (B, min(RING, cfg.sliding_window), cfg.num_kv_heads,
             cfg.head_dim)
    live = (np.arange(shape[1]) < filled)[None, :, None, None]
    if cfg.kv_quant:
        ring = {n: (rng.integers(-127, 128, shape) * live).astype(np.int8)
                for n in ("k", "v")}
        ring.update({f"{n}_scale": (rng.uniform(1e-3, 2e-2, shape[:3])
                                    * live[..., 0]).astype(np.float16)
                     for n in ("k", "v")})
        return ring
    return {n: (rng.normal(size=shape) * live).astype(np.float32)
            for n in ("k", "v")}


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("index", [20, 150])
def test_apply_attention_decode_matches_reference(index, kv_quant):
    """index 20 leaves the 64-slot ring unwrapped; 150 has wrapped it twice
    and the window (64) cuts. Under kv_quant the written ring (int8 payload
    and f16 scales) is bit-equal to the reference's; the f32 ring's new
    slot (projection and RoPE) is held at TOL and the rest bit-equal."""
    jcfg, tcfg, jp, _ = _pair(kv_quant=kv_quant)
    jparams, tparams = _attn_params(tcfg, jp)
    cache = _ring(tcfg, index, min(index, 64))
    x = np.random.default_rng(index + 1).normal(
        size=(B, 1, tcfg.d_model)).astype(np.float32)
    jout, jcache = JL.apply_attention_decode(
        jparams, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.int32(index), jcfg)
    tcache = {k: _t(v) for k, v in cache.items()}
    out, tcache = L.apply_attention_decode(tparams, _t(x), tcache, index,
                                           tcfg)
    _close(out, jout, f"decode out index={index}")
    assert set(tcache) == set(jcache)
    slot = index % 64
    for name in jcache:
        got, want = tcache[name], np.asarray(jcache[name])
        if not kv_quant:
            _close(got[:, slot], want[:, slot], f"ring {name} new slot")
            got, want = got[:, np.arange(64) != slot], \
                want[:, np.arange(64) != slot]
        _equal(got, want, f"ring {name}")


def _ref_forward(jcfg, jp, toks):
    return j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                     return_cache=True)


def test_forward_caches_and_decode_match_reference():
    """Teacher-forced: forward over an 11-token prompt (logits, SSM states
    and the shared K/V of each of the 3 slots), the hand-off to a decode
    state, then 5 decode steps, each against the reference on the same
    tokens."""
    jcfg, tcfg, jp, model = _pair()
    t_pre = 11
    toks = _tokens(tcfg, t_pre + T_DEC)
    jlog, _, jc = _ref_forward(jcfg, jp, toks[:, :t_pre])
    with torch.inference_mode():
        tlog, _, tc = forward(model, {"tokens": _t(toks[:, :t_pre])},
                              return_cache=True)
    _close(tlog, jlog, "logits")
    for k in ("ssm", "conv"):
        _close(tc["ssm_states"][k], jc["ssm_states"][k], f"ssm_states {k}")
    for k in ("k", "v"):
        assert tuple(tc["shared_kv"][k].shape) == (3, B, t_pre, 4, 32)
        _close(tc["shared_kv"][k], jc["shared_kv"][k], f"shared_kv {k}")
    jst = j_cache_from_prefill(jc, jcfg, B, RING, t_pre)
    tst = cache_from_prefill(tc, tcfg, B, RING, t_pre)
    for i in range(T_DEC):
        tok = toks[:, t_pre + i:t_pre + i + 1]
        jl, jst = j_decode_step(jp, jnp.asarray(tok), jst,
                                jnp.int32(t_pre + i), jcfg)
        tl, tst = decode_step(model, _t(tok), tst, t_pre + i)
        _close(tl, jl, f"decode logits step {i}")
        for k in ("ssm", "conv"):
            _close(tst[k], jst[k], f"decode {k} step {i}")
        for k in ("k", "v"):
            _close(tst["shared_kv"][k], jst["shared_kv"][k],
                   f"decode ring {k} step {i}")


@pytest.mark.parametrize("t_pre", [11, 100])
def test_cache_from_prefill_rings_bit_equal(t_pre):
    """The reference's own prefill caches through both hand-offs: 11
    positions fill slots [0, 11) of the 64-slot ring; 100 wrap it, each
    position p in slot p % 64."""
    jcfg, tcfg, jp, _ = _pair()
    _, _, jc = _ref_forward(jcfg, jp, _tokens(tcfg, t_pre, seed=t_pre))
    tc = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jc)
    jst = j_cache_from_prefill(jc, jcfg, B, RING, t_pre)
    tst = cache_from_prefill(tc, tcfg, B, RING, t_pre)
    assert set(tst) == set(jst) == {"ssm", "conv", "shared_kv"}
    for k in ("ssm", "conv"):
        _equal(tst[k], jst[k], k)
    for k in ("k", "v"):
        assert tuple(tst["shared_kv"][k].shape) == (3, B, 64, 4, 32)
        _equal(tst["shared_kv"][k], jst["shared_kv"][k], f"ring {k}")


def test_kv_quant_decode_from_empty_rings_matches_reference():
    """The int8 rings from init_decode_state (the hybrid + kv_quant path
    the reference runs), 6 decode steps, rings bit-equal each step."""
    jcfg, tcfg, jp, model = _pair(kv_quant=True)
    jst = j_init_decode_state(jcfg, B, RING)
    tst = init_decode_state(tcfg, B, RING, device="cpu")
    assert tst["shared_kv"]["k"].dtype == torch.int8
    assert tst["shared_kv"]["k_scale"].dtype == torch.float16
    toks = _tokens(tcfg, 6, seed=4)
    for i in range(6):
        jl, jst = j_decode_step(jp, jnp.asarray(toks[:, i:i + 1]), jst,
                                jnp.int32(i), jcfg)
        tl, tst = decode_step(model, _t(toks[:, i:i + 1]), tst, i)
        _close(tl, jl, f"kv_quant decode logits step {i}")
        for name in jst["shared_kv"]:
            _equal(tst["shared_kv"][name], jst["shared_kv"][name],
                   f"ring {name} step {i}")


def test_kv_quant_prefill_handoff_is_refused_by_name():
    _, tcfg = _cfgs(kv_quant=True)
    model = init_model(tcfg, device="cpu")
    with torch.inference_mode():
        _, _, caches = forward(model, {"tokens": _t(_tokens(tcfg, 11))},
                               return_cache=True)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        cache_from_prefill(caches, tcfg, B, RING, 11)


@pytest.mark.parametrize("t_pre", [11, 100])
def test_prefill_then_decode_continuity(t_pre):
    """tests/test_serving.py's contract on the port: 5 decode steps after
    the hand-off against the full forward; 100 > the 64-slot ring."""
    _, cfg = _cfgs()
    model = init_model(cfg, seed=0, device="cpu")
    toks = _t(_tokens(cfg, t_pre + T_DEC, seed=t_pre))
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": toks})
    logits_pre, caches = prefill(model, {"tokens": toks[:, :t_pre]})
    state = cache_from_prefill(caches, cfg, B, RING, t_pre)
    outs = []
    for i in range(T_DEC):
        lg, state = decode_step(model, toks[:, t_pre + i:t_pre + i + 1],
                                state, t_pre + i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full[:, t_pre:t_pre + T_DEC].numpy(),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(logits_pre[:, -1].numpy(),
                               full[:, t_pre - 1].numpy(), rtol=3e-3,
                               atol=3e-3)


def test_one_attention_per_shared_slot_per_prefill(monkeypatch):
    """With counting twins: a prefill makes one swa_attention call per
    shared slot and one ssd_chunk call per layer; a decode step makes
    neither."""
    counts = {"swa": 0, "ssd": 0}

    def counting(key, fn):
        def wrapped(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(sw, "swa_attention_plain",
                        counting("swa", sw.swa_attention_plain))
    monkeypatch.setattr(sc, "ssd_intra_chunk_grouped_plain",
                        counting("ssd", sc.ssd_intra_chunk_grouped_plain))
    _, cfg = _cfgs()
    model = init_model(cfg, seed=0, device="cpu")
    toks = _t(_tokens(cfg, 100, seed=2))
    logits, caches = prefill(model, {"tokens": toks})
    assert counts == {"swa": 3, "ssd": 5}
    state = cache_from_prefill(caches, cfg, B, RING, 100)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(3):
        tok, state = serve(model, tok, state, 100 + i)
    assert counts == {"swa": 3, "ssd": 5}


def test_serve_cli_runs_zamba2_with_a_prompt_past_the_ring():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--demo", "--device", "cpu", "--prompt-len", "100", "--steps", "4"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for line in ("arch=zamba2-7b-reduced", "prefill: 100 tokens",
                 "ms/step", "tok/s", "sampled ids"):
        assert line in res.stdout, res.stdout
