"""Port's dense family (smollm-135m, olmo-1b, minicpm-2b, granite-3-8b),
CPU side, on the four reduced configs and reduced smollm with 6 query
heads over 2 kv heads (a GQA group of 3, as the full smollm's 9 over 3):
the reference's params carried across with ``params_from_jax``; the
forward's logits and per-layer caches at T = 40 and at T = 2,112 (past
the reference's flash threshold: its ``_flash`` scan, the port's
``ops.swa_attention`` at both); the prefill -> decode hand-off (rings,
f32 and int8 with f16 scales, bit-equal to the reference's, with and
without a wrap); teacher-forced decode steps; the port's own continuity;
one attention call per layer per prefill and none per decode step; the
full configs and their param counts; the serve CLI's default arch. Inputs
come from fixed numpy seeds; tolerance is the reference's LM tolerance.
A reduced dense model runs on the card in tests/test_torch_cuda.py."""
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
from repro.launch.steps import abstract_params  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    cache_from_prefill as j_cache_from_prefill)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402
from repro_torch.launch.steps import prefill, serve  # noqa: E402
from repro_torch.models import (active_param_count,  # noqa: E402
                                decode_step, forward, init_model,
                                param_count)
from repro_torch.models.transformer import (  # noqa: E402
    AttentionBlock, cache_from_prefill, params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
# the reference's LM tolerance (tests/test_fused_round.py:57)
TOL = dict(rtol=1e-4, atol=1e-5)
B, T_DEC, RING = 2, 6, 64
ARCHS = ("smollm-135m", "olmo-1b", "minicpm-2b", "granite-3-8b")
# (arch, overrides): the four reduced configs, and smollm with a GQA group
# of 3 (the reduced configs have groups of 4 and 1 only)
VARIANTS = tuple((a, {}) for a in ARCHS) + (
    ("smollm-135m", dict(num_heads=6, num_kv_heads=2)),)
IDS = ("smollm", "olmo", "minicpm", "granite", "smollm-gqa3")
# the published param counts, reckoned from shapes
FULL_PARAMS = {"smollm-135m": 134_515_008, "olmo-1b": 1_176_764_416,
               "minicpm-2b": 2_724_880_896, "granite-3-8b": 8_372_187_136}

variants = pytest.mark.parametrize("arch,over", VARIANTS, ids=IDS)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **over):
    return (dataclasses.replace(j_get_reduced(arch), **over),
            dataclasses.replace(get_reduced(arch), **over))


def _pair(arch, **over):
    jcfg, tcfg = _cfgs(arch, **over)
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


def _dense_count(cfg) -> int:
    """Params of a dense config from its shapes: per layer the Q/K/V/O
    projections, the SwiGLU MLP and two RMSNorm scales (none for OLMo's
    non-parametric norm); the embedding, the untied unembedding and the
    final norm."""
    d, hd = cfg.d_model, cfg.head_dim
    norm = 0 if cfg.norm == "nonparam_ln" else d
    layer = (d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
             + cfg.num_heads * hd * d + 3 * d * cfg.d_ff + 2 * norm)
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return embed + cfg.num_layers * layer + norm


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference_and_counts_params(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert tcfg.family == "dense"
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(j_get_reduced(arch)) == \
        dataclasses.asdict(get_reduced(arch))
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(abstract_params(jcfg)))
    # the port's own count from shapes (no full init on the CPU)
    assert n == _dense_count(tcfg) == FULL_PARAMS[arch]


def test_gqa3_variant_is_a_valid_reference_config():
    arch, over = VARIANTS[-1]
    jcfg, tcfg = _cfgs(arch, **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.num_heads // tcfg.num_kv_heads, tcfg.head_dim) == (3, 32)
    for cls in (JModelConfig, type(tcfg)):
        with pytest.raises(ValueError, match="num_kv_heads"):
            cls(name="bad", family="dense", num_layers=1, d_model=64,
                num_heads=6, num_kv_heads=4, d_ff=64, vocab_size=64)


@variants
def test_init_model_tree_matches_abstract_params(arch, over):
    """The port's init: every leaf of the reference's tree (layers
    unstacked), with its shape and dtype, and nothing else."""
    jcfg, tcfg = _cfgs(arch, **over)
    model = init_model(tcfg, seed=0, device="cpu")
    sd = model.state_dict()
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            abstract_params(jcfg)):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(tcfg.num_layers):
                want[f"layers.{i}.{'.'.join(keys[1:])}"] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert ("layers.0.ln1.scale" in sd) == (tcfg.norm != "nonparam_ln")
    assert ("embedding.unembed" in sd) == (not tcfg.tie_embeddings)
    assert all(isinstance(b, AttentionBlock) for b in model.layers)
    assert model.shared_attn is None
    assert active_param_count(model, tcfg) == param_count(model) == sum(
        int(np.prod(s)) for s in want.values())


@variants
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(arch, over, dtype):
    """Every leaf bit for bit (OLMo's None norms stay None)."""
    jcfg, tcfg, jp, model = _pair(arch, param_dtype=dtype, **over)
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
        want = (leaf.view(np.uint16) if leaf.dtype.name == "bfloat16"
                else leaf)
        have = (got.view(torch.int16).numpy().view(np.uint16)
                if got.dtype == torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(have, want, err_msg=names[0])
    assert seen == set(sd)
    assert (model.layers[0].ln1 is None) == (tcfg.norm == "nonparam_ln")


def _ref_forward(jcfg, jp, toks):
    return j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                     return_cache=True)


@variants
@pytest.mark.parametrize("t", [40, 2112])
def test_forward_logits_and_caches_match_reference(arch, over, t):
    """T = 2,112 is past ATTN_CHUNK_THRESHOLD: the reference takes its
    _flash scan there and its masked einsum at T = 40; the port takes
    ops.swa_attention over the full causal triangle at both."""
    assert (t > JL.ATTN_CHUNK_THRESHOLD) == (t == 2112)
    jcfg, tcfg, jp, model = _pair(arch, **over)
    assert tcfg.sliding_window is None and tcfg.causal
    toks = _tokens(tcfg, t, seed=t)
    jlog, _, jc = _ref_forward(jcfg, jp, toks)
    with torch.inference_mode():
        tlog, aux, tc = forward(model, {"tokens": _t(toks)},
                                return_cache=True)
    _close(tlog, jlog, f"logits T={t}")
    assert float(aux) == 0.0
    assert set(tc) == set(jc) == {"k", "v"}
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == (tcfg.num_layers, B, t,
                                      tcfg.num_kv_heads, tcfg.head_dim)
        _close(tc[k], jc[k], f"cache {k} T={t}")


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("t_pre", [11, 100])
def test_cache_from_prefill_rings_bit_equal(arch, over, kv_quant, t_pre):
    """The reference's own prefill caches through both hand-offs: 11
    positions fill slots [0, 11) of the 64-slot ring; 100 wrap it, each
    position p in slot p % 64. Under kv_quant the int8 payloads and the
    f16 scales are bit-equal."""
    jcfg, tcfg, jp, _ = _pair(arch, kv_quant=kv_quant, **over)
    _, _, jc = _ref_forward(jcfg, jp, _tokens(tcfg, t_pre, seed=t_pre))
    tc = {k: _t(np.asarray(v)) for k, v in jc.items()}
    jst = j_cache_from_prefill(jc, jcfg, B, RING, t_pre)
    tst = cache_from_prefill(tc, tcfg, B, RING, t_pre)
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_quant else set())
    assert set(tst) == set(jst) == names
    for k in names:
        assert tst[k].shape[:3] == (tcfg.num_layers, B, RING)
        _equal(tst[k], jst[k], f"ring {k}")
    if kv_quant:
        assert tst["k"].dtype == torch.int8
        assert tst["k_scale"].dtype == torch.float16


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_steps_match_reference(arch, over, kv_quant):
    """Teacher-forced: the reference's caches of an 11-token prompt handed
    off by each package, then 6 decode steps, each step's logits and
    rings against the reference on the same tokens (the f32 rings at TOL,
    the int8 payloads and f16 scales bit-equal)."""
    jcfg, tcfg, jp, model = _pair(arch, kv_quant=kv_quant, **over)
    t_pre = 11
    toks = _tokens(tcfg, t_pre + T_DEC, seed=3)
    _, _, jc = _ref_forward(jcfg, jp, toks[:, :t_pre])
    jst = j_cache_from_prefill(jc, jcfg, B, RING, t_pre)
    tst = cache_from_prefill({k: _t(np.asarray(v)) for k, v in jc.items()},
                             tcfg, B, RING, t_pre)
    for i in range(T_DEC):
        tok = toks[:, t_pre + i:t_pre + i + 1]
        jl, jst = j_decode_step(jp, jnp.asarray(tok), jst,
                                jnp.int32(t_pre + i), jcfg)
        tl, tst = decode_step(model, _t(tok), tst, t_pre + i)
        _close(tl, jl, f"decode logits step {i}")
        assert set(tst) == set(jst)
        for k in jst:
            if kv_quant:
                _equal(tst[k], jst[k], f"ring {k} step {i}")
            else:
                _close(tst[k], jst[k], f"ring {k} step {i}")


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_then_decode_continuity(arch, over, kv_quant):
    """tests/test_serving.py's contract on the port: decode steps after the
    hand-off against the full forward, at 3e-3 (f32 rings); on the int8
    rings within 2% of the largest logit, as its int8 hand-off test."""
    _, cfg = _cfgs(arch, kv_quant=kv_quant, **over)
    model = init_model(cfg, seed=0, device="cpu")
    t_pre = 11
    toks = _t(_tokens(cfg, t_pre + T_DEC, seed=5))
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": toks})
    logits_pre, caches = prefill(model, {"tokens": toks[:, :t_pre]})
    state = cache_from_prefill(caches, cfg, B, RING, t_pre)
    outs = []
    for i in range(T_DEC):
        lg, state = decode_step(model, toks[:, t_pre + i:t_pre + i + 1],
                                state, t_pre + i)
        outs.append(lg[:, 0])
    dec, want = torch.stack(outs, 1), full[:, t_pre:t_pre + T_DEC]
    np.testing.assert_allclose(logits_pre[:, -1].numpy(),
                               full[:, t_pre - 1].numpy(), rtol=3e-3,
                               atol=3e-3)
    if kv_quant:
        assert float((dec - want).abs().max() / full.abs().max()) < 0.02
    else:
        np.testing.assert_allclose(dec.numpy(), want.numpy(), rtol=3e-3,
                                   atol=3e-3)


@variants
def test_one_attention_per_layer_per_prefill(arch, over, monkeypatch):
    """With counting twins: a prefill makes one swa_attention call per
    layer and no ssd_chunk call; a decode step makes neither."""
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
    _, cfg = _cfgs(arch, **over)
    model = init_model(cfg, seed=0, device="cpu")
    logits, caches = prefill(model, {"tokens": _t(_tokens(cfg, 30))})
    assert counts == {"swa": cfg.num_layers, "ssd": 0}
    state = cache_from_prefill(caches, cfg, B, RING, 30)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(3):
        tok, state = serve(model, tok, state, 30 + i)
    assert counts == {"swa": cfg.num_layers, "ssd": 0}


def test_serve_cli_defaults_to_smollm():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--demo",
         "--device", "cpu", "--prompt-len", "40", "--steps", "4"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for line in ("arch=smollm-135m-reduced", "prefill: 40 tokens",
                 "ms/step", "tok/s", "sampled ids"):
        assert line in res.stdout, res.stdout
