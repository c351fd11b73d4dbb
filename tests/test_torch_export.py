"""The port's torch.export artifacts (vstnet_tpu_torch/runtime/export.py,
cli/export.py) against the JAX package's live functions.

Each artifact is exported on the CPU, serialized to `.pt2` bytes, loaded
back with load_exported and run on numpy-seeded inputs:

  * encoder, decoder and the whole stylize program (tiny RevResNet, one
    block a stage, weights from vstnet_tpu's init_revresnet): within 1e-4
    of vstnet_tpu's encode / decode / cwct.transfer (float32 roundoff
    through the network and the 32x32 Cholesky), and equal to the port's
    eager functions bit for bit (the same operators on the same CPU; the
    stylize program sums its cWCT statistics in float64, cwct._accumulate's
    export rule, so it is held to the eager stylize under that rule);
  * the segmenter at the smallest depth SegFormer takes (one block a
    stage): masks equal to vstnet_tpu's segment_mask (on these seeded
    weights and inputs the best class leads its runner-up by at least
    1.1e-5, and the packages' logits differ by at most 5e-7);
  * segment-render: within 1e-4 of vstnet_tpu's segment -> self-remap ->
    palette -> blend.

The remapping's label counts (a scatter-add into a fixed-length vector, so
that their shape does not depend on the data) equal numpy's bincount.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models import remapping as jremap
from vstnet_tpu.models import revresnet as jrev
from vstnet_tpu.models import segformer as jsf
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import (
    params_from_jax,
    segformer_params_from_jax,
)
from vstnet_tpu_torch.models import cwct, remapping
from vstnet_tpu_torch.models import segformer as sf
from vstnet_tpu_torch.models.pipeline import stylize
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.runtime import export as ex

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
JSMALL = JaxConfig(n_blocks=(1, 1, 1))
TINY = (1, 1, 1, 1)

_jencode = jax.jit(lambda p, x: jrev.encode(p, x, JSMALL))
_jdecode = jax.jit(lambda p, z: jrev.decode(p, z, JSMALL))
_jstylize = jax.jit(lambda p, c, s: jrev.decode(p, jcwct.transfer(
    jrev.encode(p, c, JSMALL), jrev.encode(p, s, JSMALL)), JSMALL))
_jmask = jax.jit(jsf.segment_mask)


def _rev_pair(seed):
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jrev.init_revresnet(k, JSMALL))(jax.random.PRNGKey(seed)))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return params, net


@pytest.fixture(scope="module")
def rev():
    return _rev_pair(0)


@pytest.fixture(scope="module")
def seg():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsf.init_segformer(k, TINY))(jax.random.PRNGKey(2)))
    net = sf.SegFormer(TINY, device="cpu")
    net.load_state_dict(segformer_params_from_jax(params))
    return params, net


def _load(blob):
    assert isinstance(blob, bytes)
    return ex.load_exported(blob, device="cpu")


def test_encoder_and_decoder_artifacts(rev, rng):
    params, net = rev
    h, w = 24, 32
    blob, zshape = ex.export_encoder(net, SMALL, h, w, device="cpu",
                                     serialized=True)
    x = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    got = _load(blob)(torch.from_numpy(x)).numpy()
    ref = np.asarray(_jencode(params, x))
    assert got.shape == zshape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, net.encode(torch.from_numpy(x)))

    blob, oshape = ex.export_decoder(net, SMALL, h, w, device="cpu",
                                     serialized=True)
    z = (rng.standard_normal(zshape) * 0.1).astype(np.float32)
    got = _load(blob)(torch.from_numpy(z)).numpy()
    assert got.shape == oshape
    np.testing.assert_allclose(got, np.asarray(_jdecode(params, z)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, net.decode(torch.from_numpy(z)))


def _float64_sums(monkeypatch):
    """cwct._accumulate's rule while torch.export traces (float64 for a
    float32 latent), applied to eager CPU code."""
    monkeypatch.setattr(cwct, "_accumulate", lambda x: (
        torch.float64 if x.dtype == torch.float32 else x.dtype))


@pytest.mark.parametrize("bake", [True, False])
def test_stylize_artifact(rev, rng, bake, monkeypatch):
    import io

    params, net = rev
    ep, oshape = ex.export_stylize(net, SMALL, 16, 16, bake_weights=bake,
                                   device="cpu")
    # weights as inputs: the program holds none; nor example inputs
    assert len(ep.state_dict) == (len(net.state_dict()) if bake else 0)
    assert ep.example_inputs is None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    weights = sum(v.numel() * 4 for v in net.state_dict().values())
    assert (len(buf.getvalue()) > weights) == bake
    fn = _load(buf.getvalue())
    c = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    s = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    tc, ts = torch.from_numpy(c), torch.from_numpy(s)
    if bake:
        pairs = [(params, net, fn(tc, ts))]
    else:
        # one artifact, the weights as inputs: two weight sets
        other = _rev_pair(1)
        pairs = [(p, n, fn(dict(n.state_dict()), tc, ts))
                 for p, n in (rev, other)]
    for p, n, got in pairs:
        assert tuple(got.shape) == oshape
        np.testing.assert_allclose(got.numpy(), np.asarray(_jstylize(p, c, s)),
                                   rtol=1e-4, atol=1e-4)
        with monkeypatch.context() as m:
            _float64_sums(m)
            np.testing.assert_array_equal(got, stylize(n, tc, ts))


def _float32_stats(x):
    """cwct._stats' float32 arithmetic on the CPU, spelled out: the mean
    over the pixels, the centred Gram / (n - 1) by bmm."""
    b, g, c, n = x.shape
    mean = x.mean(dim=(1, 3))
    xc = (x - mean[:, None, :, None]).transpose(1, 2).reshape(b, c, g * n)
    return mean, torch.bmm(xc, xc.transpose(1, 2)) / (g * n - 1)


def test_exported_statistics_are_summed_in_float64(rev, rng):
    """cwct._accumulate's export rule: a stylize program traced on the CPU
    casts each latent (content and style) to float64 before its mean and
    its Gram, as one traced on the card does, so that it computes what the
    card's eager program computes once load_exported or
    native.package_program moves it to the card. Eager _stats on the CPU
    keeps its float32 sums, bit for bit."""
    _, net = rev
    ep, _ = ex.export_stylize(net, SMALL, 16, 16, device="cpu")

    def dtype(a):
        return getattr(a.meta.get("val"), "dtype", None)

    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    casts = [n for n in calls if dtype(n) == torch.float64
             and dtype(n.args[0]) == torch.float32]
    sums = [n for n in calls if n.target in (torch.ops.aten.mean.dim,
                                             torch.ops.aten.bmm.default)]
    assert len(casts) == 2 and len(sums) == 4
    for n in sums:
        assert dtype(n) == torch.float64
        assert all(dtype(a) == torch.float64 for a in n.args
                   if isinstance(a, torch.fx.Node))
    x = torch.from_numpy(rng.standard_normal((2, 1, 32, 64)).astype(
        np.float32) * np.float32(0.5) + np.float32(0.3))
    for got, want in zip(cwct._stats(x), _float32_stats(x)):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_segmenter_artifact(seg, rng):
    params, net = seg
    blob, mshape = ex.export_segmenter(net, 64, 64, device="cpu",
                                       serialized=True)
    x = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    got = _load(blob)(torch.from_numpy(x))
    assert tuple(got.shape) == mshape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_jmask(params, x)))


def test_segment_render_artifact(seg, rng):
    params, net = seg
    blob, oshape = ex.export_segment_render(net, 64, 64, blend=0.5,
                                            device="cpu", serialized=True)
    x = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    got = _load(blob)(torch.from_numpy(x)).numpy()
    assert got.shape == oshape
    m = jremap.self_remapping(_jmask(params, x),
                              jremap.load_label_mapping(), 0.02)
    pal = jnp.asarray(jremap.ade20k_palette(), jnp.float32) / 255.0
    color = pal[jnp.clip(m, 0, pal.shape[0] - 1)]
    ref = np.asarray(jnp.clip(0.5 * color + 0.5 * x, 0.0, 1.0))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_export_cli_writes_the_five_artifacts(tmp_path, monkeypatch, rng):
    from vstnet_tpu_torch.cli import export as cli
    from vstnet_tpu_torch.models import pipeline

    load = sf.Segmenter.load.__func__
    monkeypatch.setattr(pipeline, "PHOTO_CONFIG", SMALL)
    monkeypatch.setattr(sf.Segmenter, "load", classmethod(
        lambda cls, *a, **k: load(cls, *a, depths=TINY, **k)))
    written = cli.main(["--what", "all", "--height", "32", "--width", "32",
                        "--device", "cpu", "-o", str(tmp_path)])
    names = ["stylize", "encoder", "decoder", "segmenter", "segment_render"]
    assert written == [str(tmp_path / f"{n}_32x32.pt2") for n in names]
    c = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(
        np.float32))
    out = ex.load_exported(written[0], device="cpu")(c, c.flip(1))
    assert out.shape == (1, 32, 32, 3) and bool(torch.isfinite(out).all())
    with pytest.raises(SystemExit):
        cli.main(["--height", "30", "--device", "cpu"])


def test_label_counts_are_bincounts(rng):
    seg = rng.integers(-3, 160, size=(3, 20, 24)).astype(np.int32)
    want = np.stack([np.bincount(f[(f >= 0) & (f < 150)], minlength=150)
                     for f in seg.reshape(3, -1)])
    t = torch.from_numpy(seg)
    got = remapping._frame_counts(t)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(remapping.label_counts(t).numpy(),
                                  want.sum(0))
