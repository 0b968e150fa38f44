"""Port's mamba2-370m serving path, CPU side, on the reduced config: the
reference's params carried across, the forward (logits and SSM caches),
the prefill -> decode hand-off and teacher-forced decode steps against the
reference's on the same tokens; the port's own prefill -> decode
continuity (tests/test_serving.py's contract); greedy tokens; the serving
CLI; and the refusals of what is not ported."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    cache_from_prefill as j_cache_from_prefill)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch.steps import prefill, serve  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_state, init_model, loss_fn,
                                param_count)
from repro_torch.models.transformer import (  # noqa: E402
    cache_from_prefill, params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
# the reference's fused-vs-host tolerance (tests/test_fused_round.py:57)
TOL = dict(rtol=1e-4, atol=1e-5)
B, T_PRE, T_DEC = 2, 11, 5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(cfg_name="mamba2-370m", **over):
    jcfg = dataclasses.replace(j_get_reduced(cfg_name), **over)
    tcfg = dataclasses.replace(get_reduced(cfg_name), **over)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu")


def _tokens(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jcfg, tcfg, jp, model = _pair(param_dtype=dtype)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    sd = model.state_dict()
    assert len(sd) == sum(
        np.asarray(x).shape[0] if "layers" in jax.tree_util.keystr(p)
        else 1 for p, x in leaves)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers":
            got = [sd[f"layers.{i}.{keys[1]}.{keys[2]}"]
                   for i in range(tcfg.num_layers)]
            got = torch.stack(got)
        else:
            got = sd[".".join(keys)]
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name
        want = (leaf.view(np.uint16) if leaf.dtype.name == "bfloat16"
                else leaf)
        have = (got.view(torch.int16).numpy().view(np.uint16)
                if got.dtype == torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(have, want)
    assert param_count(model) == sum(np.asarray(x).size
                                     for _, x in leaves)


def _f32(a):
    """A torch tensor or a jax array as f32 numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_caches_and_decode_match_reference(dtype):
    """Teacher-forced: forward over the prompt (logits and SSM caches), the
    hand-off to a decode state, then T_DEC decode steps, each against the
    reference on the same tokens. f32 over T_PRE tokens at TOL; bf16
    params and compute over 64 tokens (two chunks of 32) at the bf16
    kernel tolerance, 2e-2 (tests/test_kernels.py:16): one bf16 ulp of an
    output cast at |y| ~ 4."""
    if dtype == "float32":
        over, tol, t_pre = {}, TOL, T_PRE
    else:
        over, tol, t_pre = (dict(param_dtype=dtype, compute_dtype=dtype),
                            dict(rtol=2e-2, atol=2e-2), 64)
    jcfg, tcfg, jp, model = _pair(**over)
    toks = _tokens(tcfg, t_pre + T_DEC)
    jlog, _, jc = j_forward(jp, {"tokens": jnp.asarray(toks[:, :t_pre])},
                            jcfg, return_cache=True)
    with torch.inference_mode():
        tlog, _, tc = forward(model, {"tokens": torch.from_numpy(
            toks[:, :t_pre])}, return_cache=True)
    assert str(tlog.dtype).split(".")[-1] == np.asarray(jlog).dtype.name
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_f32(tc["ssm_states"][k]),
                                   _f32(jc["ssm_states"][k]), **tol)
    jst = j_cache_from_prefill(jc, jcfg, B, 64, t_pre)
    tst = cache_from_prefill(tc, tcfg, B, 64, t_pre)
    for k in ("ssm", "conv"):
        assert str(tst[k].dtype).split(".")[-1] == \
            np.asarray(jst[k]).dtype.name
        assert dtype != "float32" or tst[k].dtype == torch.float32
        np.testing.assert_allclose(_f32(tst[k]), _f32(jst[k]), **tol)
    worst = 0.0
    for i in range(T_DEC):
        tok = toks[:, t_pre + i:t_pre + i + 1]
        jl, jst = j_decode_step(jp, jnp.asarray(tok), jst,
                                jnp.int32(t_pre + i), jcfg)
        with torch.inference_mode():
            tl, tst = decode_step(model, torch.from_numpy(tok), tst,
                                  t_pre + i)
        worst = max(worst, float(np.abs(_f32(tl) - _f32(jl)).max()))
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(_f32(tst[k]), _f32(jst[k]), **tol)
    print(f"{dtype} decode logits: max |port - reference| = {worst:.3g}")


@pytest.mark.parametrize("t_pre", [11, 40, 64])
def test_prefill_then_decode_continuity(t_pre):
    """tests/test_serving.py::test_prefill_then_decode_continuity on the
    port: T = 40 pads the last chunk of 32; T = 64 fills two."""
    cfg = get_reduced("mamba2-370m")
    model = init_model(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, t_pre + T_DEC, seed=t_pre))
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": toks})
    logits_pre, caches = prefill(model, {"tokens": toks[:, :t_pre]})
    state = cache_from_prefill(caches, cfg, B, 64, t_pre)
    outs = []
    with torch.inference_mode():
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


def test_greedy_serve_matches_reference_where_decided():
    """The serve step's greedy tokens against the reference's argmax over
    its own decode logits, where the top-2 gap exceeds the tolerance."""
    jcfg, tcfg, jp, model = _pair()
    state = init_decode_state(tcfg, B, 64, device="cpu")
    jst = jax.tree_util.tree_map(
        jnp.asarray, {k: v.numpy() for k, v in state.items()})
    tok = torch.from_numpy(_tokens(tcfg, 1, seed=3))
    decided = 0
    for i in range(8):
        jl, jst = j_decode_step(jp, jnp.asarray(tok.numpy()), jst,
                                jnp.int32(i), jcfg)
        nxt, state = serve(model, tok, state, i)
        assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (B, 1)
        top2 = np.sort(np.asarray(jl[:, -1]), axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-4
        want = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        np.testing.assert_array_equal(nxt[:, 0].numpy()[sure], want[sure])
        decided += int(sure.sum())
        tok = torch.from_numpy(want[:, None].astype(np.int32))
    assert decided >= B * 4


def test_serve_cli_runs_with_a_prompt():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-370m", "--demo", "--device", "cpu", "--prompt-len", "40",
         "--steps", "4"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    for line in ("arch=mamba2-370m-reduced", "prefill: 40 tokens",
                 "ms/step", "tok/s", "sampled ids"):
        assert line in out, out


def test_serve_cli_generates_the_prompt_continuation():
    """--prompt-len T: the first sampled token after the prompt is the
    prefill logits' argmax, and decoding continues from the hand-off."""
    from repro_torch.launch.serve import generate
    cfg = get_reduced("mamba2-370m")
    model = init_model(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(_tokens(cfg, 40, seed=9))
    out, t_pre, _, _ = generate(model, prompt, steps=3, cache=64)
    assert tuple(out.shape) == (B, 4) and t_pre is not None
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": torch.cat([prompt, out[:, :3]],
                                                         1)})
    want = full[:, 39:].argmax(-1)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_unported_archs_families_and_losses_raise_by_name(monkeypatch):
    # every arch id of the reference is ported (the vlm and audio families
    # are held in tests/test_torch_vlm.py and tests/test_torch_audio.py);
    # an id the reference does not know stays a KeyError
    with pytest.raises(KeyError, match="no-such-arch"):
        get_config("no-such-arch")
    # a family outside the zoo's is refused by name
    cfg = dataclasses.replace(get_reduced("smollm-135m"), family="encdec")
    with pytest.raises(NotImplementedError, match="encdec"):
        init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec"):
        init_decode_state(cfg, B, 64, device="cpu")
    # the MoE layer's expert-parallel dispatch over several devices (the
    # multi-GPU slice) on a reduced mixtral
    ep = dataclasses.replace(get_reduced("mixtral-8x22b"), act_ep="ep",
                             act_ep_size=2)
    model = init_model(ep, device="cpu")
    with pytest.raises(NotImplementedError, match="act_ep"):
        forward(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    # the hybrid + kv_quant prefill hand-off (the reference drops the
    # int8 rings' scales there)
    quant = dataclasses.replace(get_reduced("zamba2-7b"), kv_quant=True)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        cache_from_prefill({"ssm_states": {"ssm": torch.zeros(1),
                                           "conv": torch.zeros(1)}},
                           quant, B, 64, 11)
    with pytest.raises(NotImplementedError, match="loss_fn"):
        loss_fn(None, None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(get_reduced("mamba2-370m"))


def test_full_config_matches_reference_and_counts_370m_params():
    from repro.configs import get_config as j_get_config
    from repro.launch.steps import abstract_params
    jcfg, tcfg = j_get_config("mamba2-370m"), get_config("mamba2-370m")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(j_get_reduced("mamba2-370m")) == \
        dataclasses.asdict(get_reduced("mamba2-370m"))
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(abstract_params(jcfg)))
    # the port's own count, from shapes alone (no 1.5 GB init here)
    from repro_torch.models.ssm import _dims
    d_in, h, p, g, nst, d_xbc = _dims(tcfg)
    per_layer = (tcfg.d_model * (2 * d_in + 2 * g * nst + h)
                 + tcfg.conv_kernel * d_xbc + 3 * h + d_in
                 + d_in * tcfg.d_model + tcfg.d_model)
    assert n == tcfg.vocab_size * tcfg.d_model + tcfg.num_layers * per_layer \
        + tcfg.d_model
    assert 360e6 < n < 380e6
