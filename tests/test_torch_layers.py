"""tpu_reid_torch.models.layers against tpu_reid.models.layers (XLA path),
on the same numpy parameters and inputs, fp32."""

import ast
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_reid.models import layers as JL
import tpu_reid_torch
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops._build import kernel_impl, set_kernel_impl, use_kernels

ATOL = 2e-4  # tests/test_convert.py's full-tower tolerance
D, HID, HEADS = 64, 256, 4


def _block_params(rng, d=D, hid=HID, layers=None):
    lead = () if layers is None else (layers,)

    def f(*shape, sc=0.05, mean=0.0):
        return (mean + rng.randn(*lead, *shape) * sc).astype(np.float32)

    return {
        "attn": {"in_proj": {"w": f(d, 3 * d), "b": f(3 * d, sc=0.01)},
                 "out_proj": {"w": f(d, d), "b": f(d, sc=0.01)}},
        "ln_1": {"scale": f(d, mean=1.0), "bias": f(d)},
        "mlp": {"c_fc": {"w": f(d, hid), "b": f(hid, sc=0.01)},
                "c_proj": {"w": f(hid, d), "b": f(d, sc=0.01)}},
        "ln_2": {"scale": f(d, mean=1.0), "bias": f(d)},
    }


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=atol,
                               rtol=1e-4)


def test_layer_norm_linear_mlp_quick_gelu():
    rng = np.random.RandomState(0)
    p = _block_params(rng)
    x = rng.randn(3, 5, D).astype(np.float32)
    _close(TL.layer_norm(_t(p["ln_1"]), torch.from_numpy(x)),
           JL.layer_norm(_j(p["ln_1"]), jnp.asarray(x)), atol=1e-5)
    _close(TL.quick_gelu(torch.from_numpy(x)), JL.quick_gelu(jnp.asarray(x)), atol=1e-6)
    _close(TL.linear(_t(p["attn"]["in_proj"]), torch.from_numpy(x)),
           JL.linear(_j(p["attn"]["in_proj"]), jnp.asarray(x)), atol=1e-5)
    _close(TL.mlp(_t(p["mlp"]), torch.from_numpy(x)), JL.mlp(_j(p["mlp"]), jnp.asarray(x)),
           atol=1e-5)
    # bf16 activations keep fp32 statistics and cast back
    y = TL.layer_norm(_t(p["ln_1"]), torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("causal", [False, True])
def test_residual_block_matches_jax(impl, causal):
    rng = np.random.RandomState(1)
    p = _block_params(rng)
    s = 9
    x = rng.randn(2, s, D).astype(np.float32)
    jmask = JL.causal_mask(s) if causal else None
    tmask = TL.causal_mask(s) if causal else None
    with JL.attention_impl("xla"):
        want = JL.residual_block(_j(p), jnp.asarray(x), HEADS, jmask)
    with kernel_impl(impl):
        got = TL.residual_block(_t(p), torch.from_numpy(x), HEADS, tmask)
    _close(got, want)


def test_residual_block_cls_matches_jax_and_full_block():
    rng = np.random.RandomState(2)
    p = _block_params(rng)
    x = rng.randn(3, 11, D).astype(np.float32)
    want = JL.residual_block_cls(_j(p), jnp.asarray(x), HEADS)
    got = TL.residual_block_cls(_t(p), torch.from_numpy(x), HEADS)
    assert tuple(got.shape) == (3, 1, D)
    _close(got, want)
    full = TL.residual_block(_t(p), torch.from_numpy(x), HEADS)
    _close(got, full[:, :1].numpy())


@pytest.mark.parametrize("text_side", [False, True])
def test_splice_prompt_tokens(text_side):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, D).astype(np.float32)
    prompt = rng.randn(2, D).astype(np.float32)
    want = JL.splice_prompt_tokens(jnp.asarray(x), jnp.asarray(prompt), text_side)
    got = TL.splice_prompt_tokens(torch.from_numpy(x), torch.from_numpy(prompt), text_side)
    _close(got, want, atol=0)


def test_causal_mask():
    np.testing.assert_array_equal(TL.causal_mask(6).numpy(), np.asarray(JL.causal_mask(6)))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("text_side", [False, True])
@pytest.mark.parametrize("deep", [False, True])
def test_transformer_stack_matches_jax(impl, text_side, deep):
    """Stacked blocks with the plane/row-mask deep-prompt splice, flags
    gating layer 0 off (layers 1..depth-1 splice)."""
    rng = np.random.RandomState(4 + text_side + 2 * deep)
    n_layers, s, n_ctx = 3, 8, 2
    stacked = _block_params(rng, layers=n_layers)
    x = rng.randn(2, s, D).astype(np.float32)
    dp = rng.randn(n_layers, n_ctx, D).astype(np.float32) if deep else None
    flags = np.array([False, True, True]) if deep else None
    jmask = JL.causal_mask(s) if text_side else None
    tmask = TL.causal_mask(s) if text_side else None
    with JL.attention_impl("xla"):
        want = JL.transformer_stack(
            _j(stacked), jnp.asarray(x), HEADS, jmask,
            None if dp is None else jnp.asarray(dp),
            None if flags is None else jnp.asarray(flags), text_side,
        )
    with kernel_impl(impl):
        got = TL.transformer_stack(
            _t(stacked), torch.from_numpy(x), HEADS, tmask,
            None if dp is None else torch.from_numpy(dp),
            None if flags is None else list(flags), text_side,
        )
    _close(got, want)


def test_kernel_impl_is_scoped():
    x = torch.zeros(1)
    assert use_kernels(x) is False  # "auto": a CPU tensor takes the plain block
    with kernel_impl("kernel"):
        assert use_kernels(x) is True
        with kernel_impl("plain"):
            assert use_kernels(x) is False
        assert use_kernels(x) is True
    assert use_kernels(x) is False
    with pytest.raises(ValueError):
        set_kernel_impl("pallas")
    with contextlib.suppress(RuntimeError), kernel_impl("plain"):
        raise RuntimeError
    assert use_kernels(x) is False


def _imported_modules(path: Path, package: str):
    """Every module an `import` or `from ... import` in the file names, at
    any depth (inside functions too), relative imports resolved against
    `package`, the file's own package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            yield ".".join(base + ([node.module] if node.module else []))


def test_ops_never_import_models_and_the_kernel_policy_is_defined_once():
    """The layers point one way, models -> ops: no module of ops/ imports
    tpu_reid_torch.models, at module level or inside a function. And the
    kernel-or-plain policy has one home: `use_kernels`, `set_kernel_impl`
    and `kernel_impl` are each defined once in the package, in
    ops/_build.py."""
    root = Path(tpu_reid_torch.__file__).parent
    ops_files = sorted((root / "ops").glob("*.py"))
    assert len(ops_files) >= 6
    upward = [(f.name, m) for f in ops_files
              for m in _imported_modules(f, "tpu_reid_torch.ops")
              if m == "tpu_reid_torch.models" or m.startswith("tpu_reid_torch.models.")]
    assert upward == []
    defined = {}
    for f in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defined.setdefault(node.name, []).append(f.relative_to(root).as_posix())
    for name in ("use_kernels", "set_kernel_impl", "kernel_impl"):
        assert defined.get(name) == ["ops/_build.py"], (name, defined.get(name))


def test_slice_layer():
    rng = np.random.RandomState(5)
    stacked = _t(_block_params(rng, layers=4))
    one = TL.slice_layer(stacked, 2)
    assert tuple(one["attn"]["in_proj"]["w"].shape) == (D, 3 * D)
    head = TL.slice_layer(stacked, slice(0, 3))
    assert TL.num_layers(head) == 3
    assert torch.equal(head["mlp"]["c_fc"]["b"][2], one["mlp"]["c_fc"]["b"])
