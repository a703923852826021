"""The port's HTTP detection service (smallhardface_tpu_torch/serve.py) over
a real socket on the CPU, mirroring tests/test_serve.py: healthz, a round
trip, a bad body, concurrent requests, micro-batching equal to the
per-request path (rtol 1e-5, atol 1e-4, as JAX's test), detections that
agree with the JAX service's on the same converted weights (the golden
fixture's rule, tests/test_torch_port_slice.py:_agree), and the settings
it does not take raising."""

import copy
import http.client
import json
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import jax

from smallhardface_tpu import serve as jserve
from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu_torch import serve as tserve
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from tests.test_torch_port_slice import _agree


@pytest.fixture(scope="module")
def serve_cfg():
    saved = [(c, copy.deepcopy(c.TEST), copy.deepcopy(c.TPU))
             for c in (jcfg, tcfg)]
    for c in (jcfg, tcfg):
        c.TEST.SCALES = [50, 90]
        c.TEST.FLIP = True
        c.TPU.TEST_BUCKET = 64
        c.TEST.N_DETS_PER_MODULE = 100
    yield
    for c, test, tpu in saved:
        c.TEST.update(test)
        c.TPU.update(tpu)


def _weights():
    spec = jdm.ModelSpec(different_dilation=True)
    params = jdm.init_params(jax.random.PRNGKey(0), spec)
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    return spec, params, params_from_numpy(tree)


@pytest.fixture(scope="module")
def server(serve_cfg):
    _, _, tparams = _weights()
    service = tserve.DetectorService(
        tparams, tdm.ModelSpec(different_dilation=True), device="cpu")
    srv = tserve.serve(service, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _jpeg(shape=(96, 128), seed=0):
    im = np.random.RandomState(seed).randint(0, 255, (*shape, 3), np.uint8)
    return cv2.imencode(".jpg", im)[1].tobytes()


def _post(url, body, path="/detect?thresh=0.05"):
    req = urllib.request.Request(url + path, data=body, method="POST")
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz") as r:
        payload = json.loads(r.read())
    assert payload == {"status": "ok", "backend": "cpu", "devices": 1}


def test_detect_roundtrip(server):
    payload = _post(server, _jpeg())
    assert payload["count"] == len(payload["detections"]) >= 1
    assert all(len(det) == 5 for det in payload["detections"])


def test_bad_empty_and_chunked_bodies(server):
    for body in (b"not an image", b""):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, body)
        assert ei.value.code == 400
    host, port = server.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/detect", body=iter([_jpeg()]),
                 headers={"Transfer-Encoding": "chunked"})
    assert conn.getresponse().status == 411
    conn.close()


def test_concurrent_requests(server):
    results = []

    def hit():
        results.append(_post(server, _jpeg())["count"])

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 4 and len(set(results)) == 1


def test_micro_batching_matches_per_request(serve_cfg):
    """batch_window_ms > 0 groups concurrent requests into detect_many
    calls (two bucket keys here) with the per-request path's detections;
    a bad body fails its own caller only."""
    spec, _, tparams = _weights()
    tspec = tdm.ModelSpec(different_dilation=True)
    plain = tserve.DetectorService(tparams, tspec, device="cpu")
    batched = tserve.DetectorService(tparams, tspec, batch_window_ms=200,
                                     max_batch=4, device="cpu")
    calls = []
    many = batched.det.detect_many
    batched.det.detect_many = lambda ims, *a, **k: (
        calls.append(len(ims)) or many(ims, *a, **k))
    payloads = [_jpeg((96, 128)), _jpeg((96, 128), 1), _jpeg((64, 96), 2),
                b"not an image"]
    want = [plain.detect(p) for p in payloads[:3]]
    got = [None] * len(payloads)

    def hit(i):
        try:
            got[i] = batched.detect(payloads[i])
        except ValueError as e:
            got[i] = e

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert isinstance(got[3], ValueError)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    assert sum(calls) == 3 and max(calls) > 1


def test_service_matches_jax_service(serve_cfg):
    spec, params, tparams = _weights()
    body = _jpeg((96, 128), 3)
    want = jserve.DetectorService(params, spec).detect(body)
    got = tserve.DetectorService(
        tparams, tdm.ModelSpec(different_dilation=True),
        device="cpu").detect(body)
    _agree(got, want)


@pytest.mark.parametrize("amend,kwargs,error,what", [
    ({"PRECISION": "int8", "MASK_MODE": "band"}, {}, ValueError,
     "MASK_MODE"),
    ({"PRECISION": "int8", "MASK_MODE": "band"},
     {"calib_images": ["calib.jpg"]}, ValueError, "MASK_MODE"),
    ({"SPATIAL_DEVICES": 2}, {}, NotImplementedError, "item 14"),
], ids=["int8", "calib_images", "spatial"])
def test_unported_settings_raise(serve_cfg, amend, kwargs, error, what):
    """Spatial sharding is not ported and raises. int8 serving is ported
    (tests/test_torch_port_int8.py); like the JAX service it refuses int8
    with a "band" mask mode, before it would calibrate."""
    saved = copy.deepcopy(tcfg.TPU)
    tcfg.TPU.update(amend)
    try:
        with pytest.raises(error, match=what):
            tserve.DetectorService(None, tdm.ModelSpec(), device="cpu",
                                   **kwargs)
    finally:
        tcfg.TPU.update(saved)
