"""The port's serving daemon: the micro-batcher and HTTP contract of the JAX
daemon (tests/test_serve.py, run on the port), the three faults repaired in
the port's copy, ``build_serving_fn`` against the JAX one on a tiny
fast-heads generator, ``TileServer.from_checkpoint`` on a checkpoint dir,
and no silent CPU without a card."""

import functools
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
from mipheivit_tpu_torch.infer.serve import MicroBatcher, TileServer, build_serving_fn

torch.set_num_threads(2)

TILE = 16


def _echo_fwd(x):
    """Deterministic stand-in forward: uint8 [B,H,W,3] -> uint8 [B,H,W,2]."""
    x = x.astype(np.float32)
    out = np.stack([x.mean(-1), x.max(-1)], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def test_microbatcher_results_match_direct():
    mb = MicroBatcher(_echo_fwd, batch_size=4, item_shape=(TILE, TILE, 3), max_delay_ms=10)
    try:
        tiles = np.random.default_rng(0).integers(0, 256, (9, TILE, TILE, 3), np.uint8)
        futs = [mb.submit(t) for t in tiles]
        got = np.stack([f.result(timeout=30) for f in futs])
        np.testing.assert_array_equal(got, _echo_fwd(tiles))
        st = mb.stats()
        assert st["n_requests"] == 9
        assert 3 <= st["n_batches"] <= 9
        assert "latency_ms_p50" in st
    finally:
        mb.stop()


def test_microbatcher_coalesces_concurrent_load():
    gate = threading.Event()

    def slow_fwd(x):
        gate.wait(5)
        return _echo_fwd(x)

    mb = MicroBatcher(slow_fwd, batch_size=4, item_shape=(TILE, TILE, 3), max_delay_ms=200)
    try:
        futs = [mb.submit(t) for t in np.zeros((8, TILE, TILE, 3), np.uint8)]
        gate.set()
        for f in futs:
            f.result(timeout=30)
        assert mb.stats()["n_batches"] <= 3
    finally:
        mb.stop()


def test_requests_queued_behind_a_forward_share_a_batch():
    """Repair: requests that arrive while a forward runs are batched
    together, though the first one's deadline passed while it waited (the
    JAX batcher runs them one per batch)."""
    started = threading.Event()

    def slow_fwd(x):
        started.set()
        time.sleep(0.2)
        return _echo_fwd(x)

    mb = MicroBatcher(slow_fwd, batch_size=8, item_shape=(TILE, TILE, 3), max_delay_ms=1)
    try:
        first = mb.submit(np.zeros((TILE, TILE, 3), np.uint8))
        assert started.wait(10)
        futs = [mb.submit(np.zeros((TILE, TILE, 3), np.uint8)) for _ in range(8)]
        for f in [first] + futs:
            f.result(timeout=30)
        st = mb.stats()
        assert st["n_requests"] == 9 and st["n_batches"] == 2, st
    finally:
        mb.stop()


def test_microbatcher_deadline_flush():
    mb = MicroBatcher(_echo_fwd, batch_size=64, item_shape=(TILE, TILE, 3), max_delay_ms=20)
    try:
        t0 = time.perf_counter()
        mb.submit(np.zeros((TILE, TILE, 3), np.uint8)).result(timeout=30)
        assert time.perf_counter() - t0 < 5.0
        assert mb.stats()["n_padded_rows"] >= 63
    finally:
        mb.stop()


def test_microbatcher_rejects_bad_shape_and_propagates_errors():
    def boom(x):
        raise RuntimeError("device on fire")

    mb = MicroBatcher(boom, batch_size=2, item_shape=(TILE, TILE, 3), max_delay_ms=5)
    try:
        with pytest.raises(ValueError, match="expected"):
            mb.submit(np.zeros((TILE, TILE), np.uint8))
        with pytest.raises(RuntimeError, match="device on fire"):
            mb.submit(np.zeros((TILE, TILE, 3), np.uint8)).result(timeout=30)
        with pytest.raises(RuntimeError):     # the worker survives a failing forward
            mb.submit(np.zeros((TILE, TILE, 3), np.uint8)).result(timeout=30)
    finally:
        mb.stop()


def test_submit_racing_stop_leaves_no_future_unresolved():
    """Repair: submissions racing stop() either raise or get a Future that
    resolves (a result, or the stop error), never one that hangs."""
    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            mb = MicroBatcher(_echo_fwd, batch_size=4, item_shape=(TILE, TILE, 3),
                              max_delay_ms=1)
            futs, refused = [], []

            def client():
                for _ in range(50):
                    try:
                        futs.append(mb.submit(np.zeros((TILE, TILE, 3), np.uint8)))
                    except RuntimeError:
                        refused.append(1)

            threads = [threading.Thread(target=client) for _ in range(8)]
            for t in threads:
                t.start()
            time.sleep(0.002)
            mb.stop()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            for f in futs:
                try:
                    f.result(timeout=10)
                except RuntimeError as e:
                    assert "stopped" in str(e)
            assert len(futs) + len(refused) == 400
            with pytest.raises(RuntimeError, match="stopped"):
                mb.submit(np.zeros((TILE, TILE, 3), np.uint8))
    finally:
        sys.setswitchinterval(switch)


def test_stopped_worker_fails_what_is_left_in_the_queue():
    """Repair: entries still queued when the worker exits get the stop
    error."""
    mb = MicroBatcher(_echo_fwd, batch_size=4, item_shape=(TILE, TILE, 3))
    mb.stop()
    from concurrent.futures import Future

    fut = Future()
    mb._q.put((np.zeros((TILE, TILE, 3), np.uint8), fut, time.perf_counter()))
    mb._fail_leftovers()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=1)


def test_server_stop_before_start_returns():
    """Repair: stop() on a server that never started does not deadlock."""
    srv = TileServer(_echo_fwd, tile_size=TILE, batch_size=4, port=0)
    t = threading.Thread(target=srv.stop)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive()


@pytest.fixture
def server():
    srv = TileServer(_echo_fwd, tile_size=TILE, batch_size=4,
                     channel_names=["mean", "max"], max_delay_ms=5, port=0)
    srv.start()
    yield srv
    srv.stop()


def _post_npy(url: str, arr: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"})
    return urllib.request.urlopen(req, timeout=30)


def test_http_predict_roundtrip(server):
    base = f"http://{server.host}:{server.port}"
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        assert json.loads(r.read())["status"] == "ok"
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 256, (TILE, TILE, 3), np.uint8)
    with _post_npy(base + "/v1/predict", tile) as r:
        assert r.headers["Content-Type"] == "application/x-npy"
        assert r.headers["X-Markers"] == "mean,max"
        pred = np.load(io.BytesIO(r.read()))
    assert pred.shape == (TILE, TILE, 2) and pred.dtype == np.uint8
    np.testing.assert_array_equal(pred, _echo_fwd(tile[None])[0])
    batch = rng.integers(0, 256, (3, TILE, TILE, 3), np.uint8)
    with _post_npy(base + "/v1/predict", batch) as r:
        np.testing.assert_array_equal(np.load(io.BytesIO(r.read())), _echo_fwd(batch))
    with urllib.request.urlopen(base + "/stats", timeout=10) as r:
        assert json.loads(r.read())["n_requests"] == 4


@pytest.mark.parametrize("body", ["float32", "wrong_size", "not_npy", "empty_batch"])
def test_http_rejects_bad_input(server, body):
    """400 for a wrong dtype, a wrong size, a body that is no npy, and
    (repair) an empty batch, which the JAX daemon answers with 503."""
    url = f"http://{server.host}:{server.port}/v1/predict"
    with pytest.raises(urllib.error.HTTPError) as ei:
        if body == "float32":
            _post_npy(url, np.zeros((TILE, TILE, 3), np.float32))
        elif body == "wrong_size":
            _post_npy(url, np.zeros((TILE + 1, TILE + 1, 3), np.uint8))
        elif body == "not_npy":
            urllib.request.urlopen(urllib.request.Request(url, data=b"not npy"), timeout=10)
        else:
            _post_npy(url, np.zeros((0, TILE, TILE, 3), np.uint8))
    assert ei.value.code == 400


def test_http_concurrent_clients(server):
    base = f"http://{server.host}:{server.port}"
    tiles = np.random.default_rng(2).integers(0, 256, (16, TILE, TILE, 3), np.uint8)
    results, errors = [None] * len(tiles), []

    def client(i):
        try:
            with _post_npy(base + "/v1/predict", tiles[i]) as r:
                results[i] = np.load(io.BytesIO(r.read()))
        except Exception as e:     # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(tiles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    for got, want in zip(results, _echo_fwd(tiles)):
        np.testing.assert_array_equal(got, want)


GEOM = dict(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2, num_heads=2,
            mlp_hidden_dim=256, reg_tokens=4)
HE = {"mean": [180.0, 120.0, 160.0], "std": [50.0, 40.0, 45.0]}


def test_serving_fn_matches_jax(monkeypatch):
    """A tiny fast-heads generator, f32, the same weights in both packages
    (JAX: K1, K2 and K3 in interpret mode): the port's serving function
    within one uint8 step of the JAX one (both round half to even)."""
    import jax
    import jax.numpy as jnp

    import mipheivit_tpu.models.mipheivit as jax_mipheivit
    from mipheivit_tpu.data.stats import Normalizer as JaxNormalizer
    from mipheivit_tpu.infer.loading import to_fast_heads as jax_fast_heads
    from mipheivit_tpu.infer.serve import build_serving_fn as jax_serving_fn
    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu_torch.data.stats import Normalizer
    from mipheivit_tpu_torch.infer.loading import to_fast_heads
    from mipheivit_tpu_torch.models import MipheiViT, ViTConfig
    from mipheivit_tpu_torch.models.convert import state_dict_from_jax

    jcfg = JaxViTConfig(**GEOM, attn_impl="flash_interpret", mlp_impl="pallas_interpret",
                        remat=False)
    jmodel = JaxMipheiViT(vit_cfg=jcfg, out_chans=16)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
            jax.random.PRNGKey(0)))
    blocks = variables["params"]["encoder"]["vit"]["blocks"]
    for name in ("ls1", "ls2"):
        blocks[name] = rng.uniform(0.05, 0.15, blocks[name].shape).astype(np.float32)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim and v.min() == 1
                   else rng.standard_normal(v.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    model = MipheiViT(ViTConfig(**GEOM), out_chans=16).eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(variables, jcfg, 16).items()}, strict=False)
    to_fast_heads(model)
    jmodel, variables = jax_fast_heads(jmodel, variables)
    # the JAX decoder builds its fused heads with the default route: take the
    # Pallas kernel's (interpret mode) for this test
    monkeypatch.setattr(jax_mipheivit, "BatchedSegHeads",
                        functools.partial(jax_mipheivit.BatchedSegHeads, impl="pallas_interpret"))

    x = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
    want = jax_serving_fn(jmodel, variables, JaxNormalizer(HE, mode="he"), 32, batch_size=2)(x)
    got = build_serving_fn(model, Normalizer(HE, mode="he"), 32, batch_size=2,
                           device="cpu")(x)
    assert got.dtype == np.uint8 and got.shape == (2, 32, 32, 16)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1



class _NHWCConv(torch.nn.Module):
    """The JAX test's ``Tiny``: ``tanh(conv3x3(x)) * 0.9`` on NHWC."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 2, 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(np.array(kernel)).permute(3, 2, 0, 1))
            self.conv.bias.copy_(torch.from_numpy(np.array(bias)))

    def forward(self, x):
        return torch.tanh(self.conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1) * 0.9


def test_serving_fn_data_mesh_matches_jax():
    """The batch split over 8 replicas (``make_data_mesh(8, [cpu] * 8)``)
    against the JAX serving function on its 8-device data mesh
    (``tests/test_serve.py``'s tiny conv): within one uint8 step, and equal
    to the port's one-replica answer."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.data.stats import Normalizer as JaxNormalizer
    from mipheivit_tpu.infer.serve import build_serving_fn as jax_serving_fn
    from mipheivit_tpu.parallel import make_data_mesh as jax_data_mesh
    from mipheivit_tpu_torch.data.stats import Normalizer
    from mipheivit_tpu_torch.parallel import make_data_mesh

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return nn.tanh(nn.Conv(2, (3, 3))(x)) * 0.9

    jmodel = Tiny()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, TILE, TILE, 3)))
    conv = params["params"]["Conv_0"]
    model = _NHWCConv(conv["kernel"], conv["bias"]).eval()
    norm = {"mean": [180.0, 120.0, 160.0], "std": [50.0, 40.0, 45.0]}
    x = np.random.default_rng(4).integers(0, 256, (8, TILE, TILE, 3), np.uint8)
    want = jax_serving_fn(jmodel, params, JaxNormalizer(norm, mode="he"), TILE, batch_size=8,
                          mesh=jax_data_mesh(8))(x)
    mesh = make_data_mesh(8, ["cpu"] * 8)
    assert mesh.size == 8
    got = build_serving_fn(model, Normalizer(norm, mode="he"), TILE, batch_size=8,
                           mesh=mesh)(x)
    assert got.dtype == np.uint8 and got.shape == want.shape == (8, TILE, TILE, 2)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    solo = build_serving_fn(model, Normalizer(norm, mode="he"), TILE, batch_size=8,
                            device="cpu")(x)
    np.testing.assert_array_equal(got, solo)
    with pytest.raises(ValueError, match="split"):
        build_serving_fn(model, Normalizer(norm, mode="he"), TILE, batch_size=6, mesh=mesh)

def _tiny_generator(model_name, img_size, nc_out, encoder_name="hoptimus0",
                    dtype=torch.float32, device=None, **family_options):
    from mipheivit_tpu_torch.models import MipheiViT, ViTConfig

    assert tuple(img_size) == (32, 32) and device == torch.device("cpu")
    with torch.device(device):
        return MipheiViT(ViTConfig(**GEOM, lora_rank=8), nc_out).to(dtype).eval()


def _checkpoint(tmp_path):
    from mipheivit_tpu.config import compose, save_config
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models import MipheiViT, ViTConfig

    names = ["CD31", "CD3e", "Ki67"]
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.manual_seed(0)
    save_file(MipheiViT(ViTConfig(**GEOM, lora_rank=8), 3).state_dict(),
              ckpt / "model.safetensors")
    stats = {"RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
             **{m: {"idx_channel": i, "std": 10.0, "min": 0} for i, m in enumerate(names)}}
    (tmp_path / "channel_stats.json").write_text(json.dumps(stats))
    cfg = compose(["+default_configs=miphei-vit"])
    cfg.data.channel_stats_path = str(tmp_path / "channel_stats.json")
    cfg.data.targ_channel_names = names
    save_config(cfg, ckpt / "config.yaml")
    return ckpt, names


def test_from_checkpoint_on_cpu_answers_a_request(tmp_path, monkeypatch):
    ckpt, names = _checkpoint(tmp_path)
    monkeypatch.setattr(port_loading, "get_generator", _tiny_generator)
    srv = TileServer.from_checkpoint(str(ckpt), tile_size=32, batch_size=2, host="127.0.0.1",
                                     port=0, device="cpu")
    srv.start()
    try:
        tile = np.random.default_rng(3).integers(0, 256, (32, 32, 3), np.uint8)
        with _post_npy(f"http://{srv.host}:{srv.port}/v1/predict", tile) as r:
            assert r.headers["X-Markers"] == ",".join(names)
            pred = np.load(io.BytesIO(r.read()))
    finally:
        srv.stop()
    assert pred.shape == (32, 32, 3) and pred.dtype == np.uint8
    assert srv.batcher.stats()["n_batches"] == 1      # the warm-up is not counted


def test_from_checkpoint_over_a_data_mesh_answers_as_one_replica(tmp_path, monkeypatch):
    """``from_checkpoint(mesh=make_data_mesh(2, [cpu] * 2))``: the generator
    loaded on the mesh's first device, replicated, each replica taking half
    of every batch; the answers equal one replica's."""
    from mipheivit_tpu_torch.parallel import make_data_mesh

    ckpt, _ = _checkpoint(tmp_path)
    monkeypatch.setattr(port_loading, "get_generator", _tiny_generator)
    tiles = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), np.uint8)
    preds = []
    for mesh in (make_data_mesh(2, ["cpu"] * 2), None):
        srv = TileServer.from_checkpoint(str(ckpt), tile_size=32, batch_size=2,
                                         host="127.0.0.1", port=0, device="cpu", mesh=mesh)
        preds.append(srv.batcher.fwd_np(tiles))
        srv.stop()
    assert preds[0].shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(preds[0], preds[1])


@pytest.mark.parametrize("entry", ["from_checkpoint", "run_serve"])
def test_no_silent_cpu_without_a_card(tmp_path, monkeypatch, entry):
    from mipheivit_tpu_torch import run_serve

    ckpt, _ = _checkpoint(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "from_checkpoint":
            TileServer.from_checkpoint(str(ckpt), port=0)
        else:
            run_serve.main(["--checkpoint_dir", str(ckpt), "--port", "0"])
