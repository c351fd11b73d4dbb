"""The port's HTTP stylization service (vstnet_tpu_torch/serve.py), its
shape buckets (runtime/buckets.py) and its CLI, mirroring
tests/test_serve.py, and the service held against the JAX package's.

The port runs on device="cpu", where its kernels' wrappers run their plain
versions, on a tiny RevResNet (1 block a stage) whose weights come from
vstnet_tpu's init_revresnet through params_from_jax, so both services run
the same weights. Every wait has its own timeout, so a stuck worker fails
a test instead of holding the suite.

Tolerances:
  * port float32 service against JAX float32 service: decoded PNGs within
    1 uint8 level (float32 roundoff moves a value near a .5 boundary);
  * port fused (bf16 plain versions) against JAX float32: >= 40 dB, the
    fidelity gate of BASELINE.md;
  * a request inside a batch against the same content alone: equal PNG
    bytes.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models.pipeline import StyleModel
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.runtime import buckets
from vstnet_tpu_torch.serve import StyleService, serve

torch.set_num_threads(2)

JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
WAIT = 120.0


def _png_bytes(rng, h, w):
    from PIL import Image

    arr = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _png_array(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int32)


_INIT = jax.jit(lambda k: init_revresnet(k, JSMALL))


def _params(seed):
    return _INIT(jax.random.PRNGKey(seed))


def _model(params):
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return StyleModel(cfg=SMALL, net=net)


def _service(seed, **kw):
    kw = {"fast": False, "grid": 32, "max_size": 256, "max_batch": 4,
          "batch_window_ms": 5.0, **kw}
    return StyleService(_model(_params(seed)), **kw)


def _join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads), "a request never ended"


@pytest.fixture(scope="module")
def server():
    service = _service(0, batch_window_ms=30.0)
    httpd = serve(service, host="127.0.0.1", port=0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    service.close()
    t.join(timeout=WAIT)


def _put(url, data):
    req = urllib.request.Request(url, data=data, method="PUT")
    return urllib.request.urlopen(req, timeout=WAIT)


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    return urllib.request.urlopen(req, timeout=WAIT)


def test_healthz_and_registration(server, rng):
    base, service = server
    with urllib.request.urlopen(base + "/healthz", timeout=WAIT) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["mode"] == "photorealistic"
    assert info["device"] == "cpu"
    assert info["devices"] == 1 and info["sharded"] is False
    assert info["max_batch"] == 4 and info["fast"] is False
    if not service.batch_log:
        assert info["reply_encode_share"] is None

    with _put(base + "/styles/wave", _png_bytes(rng, 48, 40)) as r:
        assert json.loads(r.read())["registered"] == "wave"
    with urllib.request.urlopen(base + "/healthz", timeout=WAIT) as r:
        assert "wave" in json.loads(r.read())["styles"]
    # factors are shape-independent (c, c) algebra
    ls, mu = service.styles["wave"]
    c = SMALL.latent_channels
    assert ls.shape[-2:] == (c, c) and mu.shape[-1] == c

    # the reply encodes' share of the worker's time
    n = len(service.batch_log)
    _post(base + "/stylize?style=wave", _png_bytes(rng, 32, 32)).close()
    # the worker logs a batch after its last reply is released
    deadline = time.monotonic() + WAIT
    while len(service.batch_log) == n and time.monotonic() < deadline:
        time.sleep(0.01)
    with urllib.request.urlopen(base + "/healthz", timeout=WAIT) as r:
        share = json.loads(r.read())["reply_encode_share"]
    log = list(service.batch_log)
    enc = sum(e[4] for e in log)
    assert 0.0 < share < 1.0
    assert share == pytest.approx(enc / (enc + sum(e[3] for e in log)))


def test_stylize_roundtrip_and_bucketing(server, rng):
    """A content that is no bucket multiple comes back at its own size
    (padded to the 32-px bucket, cropped back); POST registers too."""
    from PIL import Image

    base, _ = server
    _post(base + "/styles/s1", _png_bytes(rng, 40, 40)).close()
    with _post(base + "/stylize?style=s1", _png_bytes(rng, 44, 52)) as r:
        assert r.headers["Content-Type"] == "image/png"
        out = Image.open(io.BytesIO(r.read()))
    assert out.size == (52, 44)  # PIL size is (W, H)
    with _post(base + "/stylize?style=s1&max_size=24",
               _png_bytes(rng, 44, 52)) as r:
        assert Image.open(io.BytesIO(r.read())).size == (24, 20)


def test_unknown_style_404(server, rng):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/stylize?style=nope", _png_bytes(rng, 32, 32))
    assert ei.value.code == 404
    assert "nope" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/elsewhere", b"")
    assert ei.value.code == 404


def test_bad_image_400(server, rng):
    base, _ = server
    _put(base + "/styles/s2", _png_bytes(rng, 32, 32)).close()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/stylize?style=s2", b"this is not an image")
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _put(base + "/styles/bad", b"not an image either")
    assert ei.value.code == 400


class _Recording(StyleService):
    """A service that keeps the number of requests in each batch."""

    def __init__(self, *a, **kw):
        self.batch_sizes = []
        super().__init__(*a, **kw)

    def _drain_batch(self, first=None):
        batch, stash = super()._drain_batch(first)
        if batch is not None:
            self.batch_sizes.append(len(batch))
        return batch, stash


def test_concurrent_requests_coalesce(rng):
    """Same-size concurrent requests all succeed with their own outputs,
    and the worker runs them in batches of more than one (the long window
    ends as soon as the batch is full)."""
    service = _Recording(_model(_params(3)), grid=32, max_size=256,
                         max_batch=4, batch_window_ms=2000.0)
    httpd = serve(service, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _put(base + "/styles/s3", _png_bytes(rng, 32, 32)).close()
        payloads = [_png_bytes(rng, 64, 64) for _ in range(4)]
        results = [None] * 4

        def go(i):
            with _post(base + "/stylize?style=s3", payloads[i]) as r:
                results[i] = r.read()

        _join_all([threading.Thread(target=go, args=(i,))
                   for i in range(4)])
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    for data in results:
        assert _png_array(data).shape == (64, 64, 3)
    # distinct inputs -> distinct stylized outputs (no cross-request mixup)
    assert len(set(results)) == 4
    assert sum(service.batch_sizes) == 4
    assert np.mean(service.batch_sizes) > 1.0, service.batch_sizes
    # the worker's per-batch record: one entry a batch, in order
    log = list(service.batch_log)
    assert [e[1] for e in log] == service.batch_sizes
    for end, n, n_pad, dev_s, enc_s in log:
        assert n <= n_pad < 2 * n and dev_s > 0.0 and enc_s > 0.0
    assert [e[0] for e in log] == sorted(e[0] for e in log)


def test_service_direct_batch_matches_single(rng):
    """A request inside a coalesced batch gives the PNG bytes of the same
    content sent alone."""
    service = _service(1, batch_window_ms=50.0)
    try:
        service.register_style("s", _png_bytes(rng, 32, 32))
        content = _png_bytes(rng, 32, 32)
        solo = service.stylize(content, "s")
        outs = [None] * 3

        def go(i, data):
            outs[i] = service.stylize(data, "s")

        others = [_png_bytes(rng, 32, 32) for _ in range(2)]
        _join_all([threading.Thread(target=go, args=(0, content))] + [
            threading.Thread(target=go, args=(i + 1, others[i]))
            for i in range(2)])
    finally:
        service.close()
    assert outs[0] == solo  # identical PNG bytes


def test_concurrent_style_registration_is_safe(rng):
    """Registrations race the batch worker: every request stylizes against
    a complete (ls, mu) pair and every registration lands."""
    service = _service(2)
    try:
        service.register_style("base", _png_bytes(rng, 32, 32))
        content = _png_bytes(rng, 32, 32)
        styles = [_png_bytes(rng, 32, 32) for _ in range(4)]
        errs, outs = [], []

        def register(i):
            try:
                service.register_style(f"s{i}", styles[i])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        def request():
            try:
                outs.append(service.stylize(content, "base"))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        _join_all([threading.Thread(target=register, args=(i,))
                   for i in range(4)]
                  + [threading.Thread(target=request) for _ in range(4)])
    finally:
        service.close()
    assert not errs
    assert len(outs) == 4 and len(set(outs)) == 1
    assert set(service.style_names()) == {"base", "s0", "s1", "s2", "s3"}


def test_trace_dir_records_the_worker_spans(rng, tmp_path):
    """A service built with trace_dir writes, when closed, a trace of
    its worker that holds each batch's device section and reply encodes
    inside the trace's window."""
    from vstnet_tpu_torch.runtime import profiling

    service = _service(5, trace_dir=str(tmp_path))
    try:
        service.register_style("s", _png_bytes(rng, 32, 32))
        for _ in range(2):
            service.stylize(_png_bytes(rng, 32, 32), "s")
    finally:
        service.close(timeout=WAIT)
    assert not service._worker.is_alive()
    (path,) = profiling.trace_files(str(tmp_path))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("vst.traced") == 1
    assert names.count("vst.serve_device") == 2
    assert names.count("vst.serve_reply_encode") == 2


def test_close_stops_the_worker():
    service = _service(4)
    service.close(timeout=WAIT)
    assert not service._worker.is_alive()


@pytest.mark.parametrize("fast", [False, True])
def test_service_matches_jax(rng, fast):
    """The port's service against the JAX package's StyleService on the
    same weights, style and content (44x52, padded to its 64x64 bucket):
    float32 within 1 uint8 level, the fused route >= 40 dB."""
    from vstnet_tpu.models.pipeline import StyleModel as JaxStyleModel
    from vstnet_tpu.serve import StyleService as JaxStyleService

    params = _params(5)
    jax_service = JaxStyleService(JaxStyleModel(cfg=JSMALL, params=params),
                                  grid=32, max_size=256, max_batch=4)
    service = StyleService(_model(params), fast=fast, grid=32, max_size=256,
                           max_batch=4)
    style = _png_bytes(rng, 40, 48)
    content = _png_bytes(rng, 44, 52)
    try:
        jax_service.register_style("s", style)
        service.register_style("s", style)
        want = _png_array(jax_service.stylize(content, "s"))
        got = _png_array(service.stylize(content, "s"))
    finally:
        service.close()
    assert got.shape == want.shape == (44, 52, 3)
    if fast:
        mse = np.mean(((got - want) / 255.0) ** 2)
        assert mse == 0 or 10 * np.log10(1.0 / mse) >= 40.0
    else:
        np.testing.assert_allclose(got, want, atol=1)


@pytest.mark.parametrize("h,w", [(44, 52), (64, 64), (1, 200), (2100, 10)])
def test_buckets_match_jax(h, w):
    """bucket_hw and pad_to_bucket (replicate) equal the JAX module's;
    crop_from_bucket undoes the padding."""
    from vstnet_tpu.runtime import buckets as jbuckets

    assert buckets.bucket_hw(h, w) == jbuckets.bucket_hw(h, w)
    assert buckets.bucket_hw(h, w, 32) == jbuckets.bucket_hw(h, w, 32)
    if max(h, w) > 2048:
        return
    x = np.random.default_rng(h * w).uniform(size=(1, h, w, 3)).astype(
        np.float32)
    got, hw = buckets.pad_to_bucket(torch.from_numpy(x), 32)
    want, jhw = jbuckets.pad_to_bucket(jnp.asarray(x), 32)
    assert hw == jhw == (h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(buckets.crop_from_bucket(got, hw).numpy(),
                                  x)


def test_bucketed_stylizer_crops_back(rng):
    model = _model(_params(6))
    c = torch.from_numpy(rng.uniform(size=(1, 44, 52, 3)).astype(
        np.float32))
    s = torch.from_numpy(rng.uniform(size=(1, 40, 40, 3)).astype(
        np.float32))
    out = buckets.BucketedStylizer(model, grid=32)(c, s)
    assert out.shape == (1, 44, 52, 3) and torch.isfinite(out).all()


def test_serve_cli_needs_a_device():
    """Without --device and with no card, the serve CLI exits with an
    error that names the flag."""
    from vstnet_tpu_torch.cli.serve import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(SystemExit) as exc:
        main(["--port", "0"])
    assert "--device cpu" in str(exc.value.code)
