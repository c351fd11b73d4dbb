"""The port's data-parallel layer (vstnet_tpu_torch/parallel) against the
JAX package's (vstnet_tpu/parallel), on the CPU.

Inference: each sharded program over two CPU replicas
(make_mesh(2, device_type="cpu")) against the JAX counterpart on a
2-device CPU mesh (Pallas in interpret mode, as tests/test_parallel.py
runs it), on the same weights (init_revresnet, carried across by
params_from_jax) and numpy frames. Training: two gloo ranks in child
processes, in tests/test_torch_parallel_train.py.

Tolerances:
  * fused programs (float32 packed weights): rtol = atol = 2e-5 against
    JAX, the bound of test_parallel.py's sharded-vs-single check; uint8
    within one level; the regional (masked) program 2e-5 with the masks
    equal, its segmenter in float32 (the bf16 route breaks the random
    tiny SegFormer's near-ties in the logits either way, so its masks
    differ between the packages on ~1 % of the pixels); the standard path
    (factored and plain) 1e-4. Each shard equals the port's single-device
    program on that shard bit for bit.
  * the service over two replicas: every reply within one uint8 level of
    a single-device reply.
"""

import copy
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstnet_tpu.models.revresnet_fast as jrf
from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models import remapping as jremap
from vstnet_tpu.models import segformer as jsf
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu.parallel import make_mesh as jmake_mesh
from vstnet_tpu.parallel import shard_batch as jshard
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import (
    params_from_jax,
    segformer_params_from_jax,
)
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import pipeline
from vstnet_tpu_torch.models import remapping as remap
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models import segformer as sf
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.parallel import (
    gather,
    make_mesh,
    parallel_stylize,
    parallel_stylize_factored,
    parallel_stylize_fused,
    parallel_stylize_masked_fused,
    replicate,
    shard_batch,
)
from vstnet_tpu_torch.parallel import multihost

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
TINY = (1, 1, 1, 1)
DEVICES = make_mesh(2, device_type="cpu")
DIST_ENV = ("VSTNET_COORDINATOR", "VSTNET_NUM_PROCESSES", "VSTNET_PROCESS_ID",
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX RevResNet params, the port's RevResNet on the same weights)."""
    params = _np_tree(jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(5)))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return params, net


@pytest.fixture
def mesh2():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    return jmake_mesh(2, axes=("data",))


@pytest.fixture
def _interpret(monkeypatch):
    from tests.conftest import patch_interpret_fused

    patch_interpret_fused(monkeypatch)


def _frames(seed, n, hw=16):
    return np.random.default_rng(seed).uniform(
        size=(n, hw, hw, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Helpers: mesh, multihost, shards, replicas
# ---------------------------------------------------------------------------

def test_process_batch_bounds_matches_jax():
    from vstnet_tpu.parallel.multihost import process_batch_bounds as jpbb

    for batch in (0, 4, 6, 16, 30, 32):
        for n in (1, 2, 3, 4):
            for pid in (-1, 0, 1, n - 1, n):
                try:
                    want = jpbb(batch, n, pid)
                except ValueError:
                    with pytest.raises(ValueError):
                        multihost.process_batch_bounds(batch, n, pid)
                    continue
                assert multihost.process_batch_bounds(batch, n, pid) == want
    # outside a group: the whole batch, as JAX's single process
    assert multihost.process_batch_bounds(16) == jpbb(16) == (0, 16)


def test_init_distributed_needs_the_environment(monkeypatch):
    import torch.distributed as dist

    for var in DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed() is False
    assert not dist.is_initialized()
    # half a description is an error, never a silent wait
    monkeypatch.setenv("VSTNET_NUM_PROCESSES", "2")
    with pytest.raises(ValueError):
        multihost.init_distributed()


def test_make_mesh(monkeypatch):
    cpu = torch.device("cpu")
    assert make_mesh(2, device_type="cpu") == (cpu,) * 2
    # the 2-D mesh: JAX's grid, n // spatial data rows of spatial devices
    assert make_mesh(4, axes=("data", "spatial"), spatial=2,
                     device_type="cpu") == ((cpu, cpu), (cpu, cpu))
    assert make_mesh(4, axes=("data", "spatial"), spatial=4,
                     device_type="cpu") == ((cpu,) * 4,)
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(6, axes=("data", "spatial"), spatial=4, device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh()


def test_shard_batch_and_gather_keep_frame_order():
    x = torch.arange(24.0).reshape(6, 2, 2)
    shards = shard_batch(make_mesh(3, device_type="cpu"), x)
    assert [s[:, 0, 0].tolist() for s in shards] == [[0, 4], [8, 12],
                                                     [16, 20]]
    assert torch.equal(gather(shards), x)
    with pytest.raises(ValueError):
        shard_batch(DEVICES, x[:5])


def test_replicated_segmenter_lays_out_its_taps_on_its_device():
    """A Segmenter replicated to another device (the meta device stands in
    for a second card) runs K5 with taps on that device, made by its own
    bf16 twin; the state_dict keys are those of the original."""
    seg = sf.Segmenter.load(None, depths=TINY, seed=3, device="cpu")
    seg.net.half_copy()          # a twin made before the copy is not kept
    (rep,) = replicate((torch.device("meta"),), seg)
    assert rep.net is not seg.net
    assert rep.label_mapping.device.type == "meta"
    assert list(rep.net.state_dict()) == list(seg.net.state_dict())
    assert not any("taps" in k for k in rep.net.state_dict())
    twin = rep.net.half_copy()
    ffns = [m for m in twin.modules() if isinstance(m, sf.MixFFN)]
    assert len(ffns) == 4
    for m in ffns:
        assert m.taps.device.type == "meta" and m.taps.dtype == torch.float32
    # .to() alone moves a MixFFN's taps with its weights
    cpu_ffn = next(m for m in seg.net.half_copy().modules()
                   if isinstance(m, sf.MixFFN))
    assert cpu_ffn.taps.device.type == "cpu"
    assert copy.deepcopy(cpu_ffn).to("meta").taps.device.type == "meta"
    # on its own device, replicate hands back the object itself
    assert replicate(DEVICES, seg) == (seg, seg)


# ---------------------------------------------------------------------------
# Sharded programs against JAX's
# ---------------------------------------------------------------------------

def _style_factors(params, net, style):
    jfast = jrf.pack_revresnet(params, JSMALL)
    fast = rf.pack_revresnet(net)
    c = SMALL.latent_channels
    ls_j, mu_j = jcwct.style_factors_packed(
        jrf.encode_fast(jfast, jnp.asarray(style), JSMALL,
                        packed_latent=True), c)
    ls, mu = cwct.style_factors_packed(
        rf.encode_fast(fast, _t(style), SMALL, packed_latent=True), c)
    return jfast, fast, (ls_j, mu_j), (ls, mu)


def test_parallel_fused_matches_jax(weights, mesh2, _interpret):
    from vstnet_tpu.parallel import parallel_stylize_fused as jfused

    params, net = weights
    frames, style = _frames(0, 4), _frames(1, 1)
    jfast, fast, (ls_j, mu_j), (ls, mu) = _style_factors(params, net,
                                                         style)
    fr_j = jshard(mesh2, jnp.asarray(frames))
    for kw, extra_j, extra in (({}, (), ()),
                               ({"out_u8": True}, (), ()),
                               ({"interp": True}, (jnp.float32(0.4),),
                                (0.4,))):
        with mesh2:
            want = np.asarray(jfused(mesh2, JSMALL, **kw)(
                jfast, fr_j, ls_j, mu_j, *extra_j))
        shards = parallel_stylize_fused(DEVICES, SMALL, **kw)(
            fast, _t(frames), ls, mu, *extra)
        assert len(shards) == 2 and shards[0].shape[0] == 2
        got = gather(shards).numpy()
        if kw.get("out_u8"):
            assert got.dtype == np.uint8
            np.testing.assert_allclose(got.astype(np.int32),
                                       want.astype(np.int32), atol=1)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
            one = pipeline.make_fused_video_fn(SMALL, **kw)
            for i, s in enumerate(shards):
                assert torch.equal(s, one(fast, _t(frames[2 * i:2 * i + 2]),
                                          ls, mu, *extra))


def test_parallel_masked_matches_jax(weights, mesh2, _interpret):
    from vstnet_tpu.parallel import parallel_stylize_masked_fused as jmasked

    params, net = weights
    seg_params = _np_tree(jax.jit(lambda k: jsf.init_segformer(k, TINY))(
        jax.random.PRNGKey(6)))
    seg_net = sf.SegFormer(TINY, device="cpu")
    seg_net.load_state_dict(segformer_params_from_jax(seg_params))
    # 64x64: the port's MiT stage 1 needs its 8x8 reduction to fit
    frames, style = _frames(2, 4, 64), _frames(3, 1, 64)
    jfast = jrf.pack_revresnet(params, JSMALL)
    fast = rf.pack_revresnet(net)
    mapping_j = jremap.load_label_mapping()
    mapping = remap.load_label_mapping()

    # the style side made once by JAX and carried across, so both
    # programs see the same per-video state
    smask = jremap.self_remapping(jsf.segment_mask(seg_params,
                                                   jnp.asarray(style)),
                                  mapping_j, 0.02)
    z_s = jrf.encode_fast(jfast, jnp.asarray(style), JSMALL)
    region_j = jcwct.style_region_factors(z_s, smask, max_labels=8)
    plan_j = jremap.video_remap_plan(smask, mapping_j)
    region = tuple(_t(x) for x in region_j)
    plan = tuple(_t(x) for x in plan_j)

    with mesh2:
        want, cm_j = jmasked(mesh2, JSMALL, min_ratio=0.02,
                             seg_half=False)(
            jfast, seg_params, mapping_j, region_j, plan_j,
            jshard(mesh2, jnp.asarray(frames)))
    outs, cms = parallel_stylize_masked_fused(DEVICES, SMALL,
                                              min_ratio=0.02,
                                              seg_half=False)(
        fast, seg_net, mapping, region, plan, _t(frames))
    np.testing.assert_array_equal(gather(cms).numpy(), np.asarray(cm_j))
    np.testing.assert_allclose(gather(outs).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    one = pipeline.make_masked_fused_video_fn(SMALL, min_ratio=0.02,
                                              seg_half=False)
    for i, (o, m) in enumerate(zip(outs, cms)):
        o1, m1 = one(fast, seg_net, mapping, region, plan,
                     _t(frames[2 * i:2 * i + 2]))
        assert torch.equal(o, o1) and torch.equal(m, m1)


def test_parallel_standard_path_matches_jax(weights, mesh2):
    from vstnet_tpu.parallel import parallel_stylize as jplain
    from vstnet_tpu.parallel import parallel_stylize_factored as jfactored

    params, net = weights
    frames, styles = _frames(4, 4), _frames(5, 4)
    fr_j = jshard(mesh2, jnp.asarray(frames))
    with mesh2:
        want = np.asarray(jplain(mesh2, JSMALL)(
            params, fr_j, jshard(mesh2, jnp.asarray(styles))))
    got = gather(parallel_stylize(DEVICES, SMALL)(net, _t(frames),
                                                  _t(styles)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    from vstnet_tpu.models.revresnet import encode as jencode

    ls_j, mu_j = jcwct.style_factors(jencode(params,
                                             jnp.asarray(styles[:1]),
                                             JSMALL))
    with mesh2:
        want = np.asarray(jfactored(mesh2, JSMALL)(params, fr_j, ls_j,
                                                   mu_j))
    ls, mu = cwct.style_factors(net.encode(_t(styles[:1])))
    got = gather(parallel_stylize_factored(DEVICES, SMALL)(
        net, _t(frames), ls, mu))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The service over two replicas
# ---------------------------------------------------------------------------

def _png_bytes(rng, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(
        np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _png_array(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int32)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "fast"])
def test_service_over_two_replicas(weights, fast):
    from vstnet_tpu_torch.serve import StyleService, serve

    _, net = weights
    model = pipeline.StyleModel(cfg=SMALL, net=net)
    kw = dict(fast=fast, grid=32, max_size=256, max_batch=4,
              batch_window_ms=200.0)
    one = StyleService(model, **kw)
    two = StyleService(model, devices=DEVICES, **kw)
    rng = np.random.default_rng(7)
    style = _png_bytes(rng, 40, 48)
    contents = [_png_bytes(rng, 44, 52) for _ in range(3)]
    try:
        assert two.devices == DEVICES and one.devices == DEVICES[:1]
        for svc in (one, two):
            svc.register_style("s", style)
        want = [_png_array(one.stylize(c, "s")) for c in contents]
        got = [None] * 3

        def go(i):
            got[i] = _png_array(two.stylize(contents[i], "s"))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        alone = _png_array(two.stylize(contents[0], "s"))
        # 3 requests pad to 4, 1 to 2: both shard over the two replicas
        assert {e[2] for e in two.batch_log} <= {2, 4}
        httpd = serve(two, host="127.0.0.1", port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
            with urllib.request.urlopen(url, timeout=120) as r:
                info = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=120)
        assert info["devices"] == 2 and info["sharded"] is True
    finally:
        one.close()
        two.close()
    for g, w in zip(got + [alone], want + [want[0]]):
        assert g.shape == (44, 52, 3)
        assert np.abs(g - w).max() <= 1
