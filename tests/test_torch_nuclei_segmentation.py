"""The port's nuclei segmentation (``mipheivit_tpu_torch.preprocessings.
nuclei_segmentation``) against the JAX package's scripts
(``preprocessings/nuclei_segmentation``, imported through ``sys.path`` as
``tests/test_flow_dynamics.py`` and ``tests/test_preprocessing.py`` import
them), on the CPU.

The host parts are equal bit for bit: the flow dynamics, the classical and
reference-dynamics pipelines, the pyramids, ``he_nuclei_inference`` (its
haematoxylin channel through the port's ``rgb2hed`` on a tensor, in f64)
and the DAPI CLI. With the CPnet backend (seeded weights at a narrow
``nbase``, ``tests/test_torch_cellpose.py``), each tile's flows are within
``FLOW_TOL`` of JAX's (relative to their largest magnitude), the averaged
fields that each chunk's ``compute_masks`` gets (spilled as float16 sums)
within ``AVG_F16_STEPS`` float16 steps of the largest magnitude, and the label
planes are compared by agreement: the share of pixels on which both call
foreground or both background, at least ``FG_AGREEMENT`` (1.0 measured
here), and the share of JAX's instances the port finds at IoU >= 0.8, at
least ``INSTANCE_AGREEMENT`` (1.0 measured here).
"""

import gzip
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.preprocessings.nuclei_segmentation import (
    backends as pb, flow_dynamics as pfd, flow_wsi as pfw, he_nuclei_inference as phe,
    wsi_nuclei_inference as pwni)
from mipheivit_tpu_torch.slideio import SlideReader, TiffSlide, write_pyramid
from test_torch_cellpose import seeded_state

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "preprocessings" / "nuclei_segmentation"))

import backends as jb  # noqa: E402
import flow_dynamics as jfd  # noqa: E402
import flow_wsi as jfw  # noqa: E402
import he_nuclei_inference as jhe  # noqa: E402
import wsi_nuclei_inference as jwni  # noqa: E402

torch.set_num_threads(2)

FLOW_TOL = 1e-4
# up to four tiles overlap a pixel: four float16 roundings of a sum up to
# four times the largest value, divided by the count (1.0 measured here)
AVG_F16_STEPS = 4
FG_AGREEMENT = 0.999
INSTANCE_AGREEMENT = 0.95


def _disk_labels(h=256, w=256, seed=0, n=25, rmin=5, rmax=9):
    """Non-overlapping disks (``tests/test_flow_dynamics.py``'s plane)."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[:h, :w]
    centers, cid = [], 0
    while cid < n:
        cy, cx = rng.integers(12, h - 12), rng.integers(12, w - 12)
        r = int(rng.integers(rmin, rmax))
        if any((cy - a) ** 2 + (cx - b) ** 2 < (r + rr + 3) ** 2 for a, b, rr in centers):
            continue
        cid += 1
        labels[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = cid
        centers.append((cy, cx, r))
    return labels


def _read(path):
    slide = TiffSlide(str(path))
    arr = slide.read_region((0, 0), 0, slide.dimensions)
    slide.close()
    return arr


def _instance_share(got, want, min_iou=0.8):
    """The share of ``want``'s instances that ``got`` holds at IoU >=
    ``min_iou``."""
    ids = np.unique(want[want > 0])
    hit = 0
    for cid in ids:
        m = want == cid
        vals, counts = np.unique(got[m], return_counts=True)
        best = vals[np.argmax(counts)]
        if best and (np.logical_and(got == best, m).sum()
                     / np.logical_or(got == best, m).sum()) >= min_iou:
            hit += 1
    return hit / max(len(ids), 1)


@pytest.fixture
def mif_slide(tmp_path):
    """``tests/test_preprocessing.py``'s mIF slide: 4 bright square nuclei
    in channel 1 over noise, 2 levels at 0.5 mpp."""
    rng = np.random.default_rng(0)
    mif = rng.integers(0, 50, (4, 256, 256), dtype=np.uint8)
    for cy, cx in [(80, 80), (80, 160), (160, 80), (160, 160)]:
        mif[1, cy - 8:cy + 8, cx - 8:cx + 8] = 200
    path = tmp_path / "mif.tiff"
    write_pyramid(str(path), mif, n_levels=2, tile_size=64, mpp=0.5)
    return str(path)


@pytest.fixture
def dapi_slide(tmp_path):
    """Five DAPI disks, one across the tile seams (``tests/
    test_preprocessing.py::test_dapi_flow_averaging_without_cellpose``)."""
    path = tmp_path / "dapi.tiff"
    write_pyramid(str(path), _dapi_disks(), n_levels=2, tile_size=64, mpp=0.325)
    return str(path)


def test_flow_dynamics_equal_jax():
    """``masks_to_flows`` and ``compute_masks`` (touching pair included)
    equal the JAX script's bit for bit, as does the reference-dynamics
    factory's round trip."""
    labels = _disk_labels(n=20, seed=2)
    yy, xx = np.mgrid[:256, :256]
    labels[(yy - 200) ** 2 + (xx - 40) ** 2 <= 36] = 21
    labels[((yy - 200) ** 2 + (xx - 52) ** 2 <= 36) & (labels != 21)] = 22
    dp, prob = pfd.masks_to_flows(labels)
    jdp, jprob = jfd.masks_to_flows(labels)
    np.testing.assert_array_equal(dp, jdp)
    np.testing.assert_array_equal(prob, jprob)
    got = pfd.compute_masks(dp, prob, min_size=10)
    np.testing.assert_array_equal(got, jfd.compute_masks(jdp, jprob, min_size=10))
    assert got.max() == 22
    noisy = dp + np.random.default_rng(0).normal(0, 0.3, dp.shape).astype(np.float32)
    np.testing.assert_array_equal(pfd.compute_masks(noisy, prob, n_iter=50),
                                  jfd.compute_masks(noisy, prob, n_iter=50))
    flow_fn, masks_fn = pfd.reference_dynamics_factory(lambda t: t.astype(np.int32))
    jflow_fn, jmasks_fn = jfd.reference_dynamics_factory(lambda t: t.astype(np.int32))
    np.testing.assert_array_equal(masks_fn(*flow_fn(labels)), jmasks_fn(*jflow_fn(labels)))


def test_segment_wsi_classical_equals_jax(mif_slide, tmp_path):
    """``segment_wsi`` with the classical backend (in RAM, as a memmap, and
    on a 1.0-mpp virtual rescale), the expansion, the boundaries and the
    band-streamed pyramid equal the JAX script's."""
    from mipheivit_tpu.slideio import SlideReader as JaxReader

    reader, jreader = (cls(mif_slide, channel_idxs=[1], mode="IF")
                       for cls in (SlideReader, JaxReader))
    got = pwni.segment_wsi(reader, pb.classical_segment, tile_size=128, halo=32, dapi_channel=0)
    want = jwni.segment_wsi(jreader, jb.classical_segment, tile_size=128, halo=32,
                            dapi_channel=0)
    np.testing.assert_array_equal(got, want)
    assert 2 <= got.max() <= 10
    mm = pwni.segment_wsi(reader, pb.classical_segment, tile_size=128, halo=32, dapi_channel=0,
                          scratch_path=str(tmp_path / "labels.raw"))
    np.testing.assert_array_equal(np.asarray(mm), want)
    np.testing.assert_array_equal(pb.expand_labels(got, 2.0), jb.expand_labels(want, 2.0))
    np.testing.assert_array_equal(pb.find_boundaries(got), jb.find_boundaries(want))
    scaled = pwni.segment_wsi(reader, pb.classical_segment, tile_size=64, halo=16,
                              dapi_channel=0, target_mpp=1.0)
    assert scaled.shape == (128, 128)
    np.testing.assert_array_equal(scaled, jwni.segment_wsi(
        jreader, jb.classical_segment, tile_size=64, halo=16, dapi_channel=0, target_mpp=1.0))
    for mod, name in ((pwni, "port"), (jwni, "jax")):
        mod.stream_labels_pyramid(mm, str(tmp_path / f"{name}.ome.tiff"), mpp=0.5,
                                  expansion_px=2.0, band_rows=64)
    np.testing.assert_array_equal(_read(tmp_path / "port.ome.tiff"),
                                  _read(tmp_path / "jax.ome.tiff"))
    reader.close()
    jreader.close()


def test_flow_segment_wsi_reference_dynamics_equals_jax(tmp_path):
    """``flow_segment_wsi`` on the model-faithful fields of a label plane
    (per-tile ``masks_to_flows``, averaged over the overlaps, chunkwise
    ``compute_masks``) equals the JAX script's plane and finds every
    instance."""
    from mipheivit_tpu.slideio import SlideReader as JaxReader

    labels = _disk_labels(n=25, seed=3)
    path = str(tmp_path / "gt.ome.tiff")
    write_pyramid(path, labels.astype(np.uint8)[None], n_levels=1, tile_size=64)
    planes = []
    for reader_cls, fd, fw in ((SlideReader, pfd, pfw), (JaxReader, jfd, jfw)):
        reader = reader_cls(path, channel_idxs=[0], mode="IF")
        flow_fn, masks_fn = fd.reference_dynamics_factory(lambda t: t.astype(np.int32))
        got = fw.flow_segment_wsi(reader, flow_fn, masks_fn, tile_size=128, overlap=32,
                                  dapi_channel=0, scratch_dir=str(tmp_path / fw.__name__),
                                  min_cellprob_sum=1.0)
        planes.append(np.array(got))
        fw.cleanup_flow_scratch(got)
        reader.close()
    np.testing.assert_array_equal(planes[0], planes[1])
    assert planes[0].max() == 25 and _instance_share(planes[0], labels) == 1.0
    assert not (tmp_path / pfw.__name__).exists()


def _dapi_disks():
    dapi = np.zeros((1, 192, 192), np.uint8)
    yy, xx = np.mgrid[:192, :192]
    for cy, cx in [(40, 40), (96, 96), (150, 40), (96, 128), (40, 150)]:
        dapi[0][(yy - cy) ** 2 + (xx - cx) ** 2 <= 64] = 220
    return dapi


@pytest.fixture(scope="module")
def cpnet(tmp_path_factory):
    """One seeded cellpose checkpoint, the port's flow backend and the JAX
    package's on it (tile 64, batch 8), and the JAX backend's run over the
    disk slide (tile 128, overlap 32): its per-tile flows and its labels.
    The random network's cellprob bias is shifted so that 30 % of the
    slide's pixels are foreground (else no instance forms). JAX's
    ``eval_flows`` builds a new ``jax.jit`` at every call; here every call
    gets one jitted forward, compiled once for the module."""
    import jax

    import mipheivit_tpu.models.cellpose_net as jcp
    from mipheivit_tpu.slideio import SlideReader as JaxReader

    state = seeded_state()
    flow_fn, _ = pfw.cellpose_torch_flow_factory(model=_cpu_cpnet(state), tile=64, batch_size=8)
    _, prob = flow_fn(_dapi_disks()[0])
    state["output.2.bias"] = state["output.2.bias"].copy()
    state["output.2.bias"][2] -= np.float32(np.quantile(prob, 0.7))
    root = tmp_path_factory.mktemp("cp")
    ckpt = root / "cp_nuclei.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, ckpt)
    slide = root / "dapi.tiff"
    write_pyramid(str(slide), _dapi_disks(), n_levels=2, tile_size=64, mpp=0.325)

    fwd = jax.jit(lambda p, t: jcp.cpnet_forward(p, t)[0])

    class _OneJit:
        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn, *args, **kw):
            return fwd

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcp, "jax", _OneJit())
        jflow_fn, jmasks_fn = jfw.cellpose_jax_flow_factory(
            params=jcp.load_cellpose_checkpoint(str(ckpt)), tile=64, batch_size=8)
        flows, averaged = [], []
        reader = JaxReader(str(slide), mode="IF")
        got = jfw.flow_segment_wsi(reader, _recording(jflow_fn, flows),
                                   _recording_inputs(jmasks_fn, averaged),
                                   tile_size=128, overlap=32, dapi_channel=0,
                                   scratch_dir=str(root / "jax_scratch"))
        plane = np.array(got)
        jfw.cleanup_flow_scratch(got)
        reader.close()
        # jax_segment_factory's composition, at the module's tile and batch
        tile = (np.random.default_rng(4).random((80, 100)) * 255).astype(np.uint8)
        tile_labels = np.asarray(jmasks_fn(*jflow_fn(tile)), np.int32)
        yield dict(ckpt=str(ckpt), slide=str(slide), flows=flows, averaged=averaged,
                   plane=plane, tile=tile,
                   tile_labels=tile_labels,
                   port=pfw.cellpose_torch_flow_factory(str(ckpt), tile=64, batch_size=8,
                                                        device="cpu"))


def _cpu_cpnet(state):
    from mipheivit_tpu_torch.models.cellpose_net import build_cpnet

    return build_cpnet(state, device="cpu")


def _recording(flow_fn, log):
    def wrapped(tile):
        out = flow_fn(tile)
        log.append(out)
        return out
    return wrapped


def _recording_inputs(masks_fn, log):
    """``masks_fn`` that keeps its inputs: the chunk's averaged fields."""
    def wrapped(dp, prob):
        log.append((dp.copy(), prob.copy()))
        return masks_fn(dp, prob)
    return wrapped


def _agree(got, want):
    assert got.shape == want.shape and want.max() > 0
    assert ((got > 0) == (want > 0)).mean() >= FG_AGREEMENT
    assert _instance_share(got, want) >= INSTANCE_AGREEMENT


def test_flow_segment_wsi_cpnet_backend_against_jax(cpnet, tmp_path):
    """The CPnet backend (DAPI/255 window, the 30/17 rescale with cv2 both
    ways, niter 113) through ``flow_segment_wsi``: every tile's flows within
    FLOW_TOL of JAX's, the label planes in agreement."""
    flow_fn, masks_fn = cpnet["port"]
    flows, averaged = [], []
    reader = SlideReader(cpnet["slide"], mode="IF")
    got = pfw.flow_segment_wsi(reader, _recording(flow_fn, flows),
                               _recording_inputs(masks_fn, averaged), tile_size=128,
                               overlap=32, dapi_channel=0, scratch_dir=str(tmp_path / "s"))
    plane = np.array(got)
    pfw.cleanup_flow_scratch(got)
    reader.close()
    assert len(flows) == len(cpnet["flows"]) == 4
    for (dp, prob), (jdp, jprob) in zip(flows, cpnet["flows"]):
        assert dp.shape == jdp.shape and dp.dtype == np.float32
        assert np.abs(dp - jdp).max() <= FLOW_TOL * np.abs(jdp).max()
        assert np.abs(prob - jprob).max() <= FLOW_TOL * np.abs(jprob).max()
    # the averaged fields each chunk's compute_masks gets (float16 sums)
    assert len(averaged) == len(cpnet["averaged"]) > 0
    for got_f, want_f in zip(averaged, cpnet["averaged"]):
        for a, b in zip(got_f, want_f):
            step = float(np.spacing(np.float16(np.abs(b).max())))
            assert a.shape == b.shape and np.abs(a - b).max() <= AVG_F16_STEPS * step
    _agree(plane, cpnet["plane"])


def test_torch_backend_per_tile_and_device_policy(cpnet, monkeypatch):
    """``torch_segment_factory`` (``get_backend("torch")``) segments a tile
    as JAX's ``jax`` backend does (labels by agreement) and, without a
    card, needs ``device="cpu"``."""
    assert callable(pb.get_backend("torch", cellpose_ckpt=cpnet["ckpt"], device="cpu"))
    seg = pb.torch_segment_factory(cpnet["ckpt"], device="cpu", tile=64, batch_size=8)
    got = seg(cpnet["tile"])
    assert got.shape == (80, 100) and got.dtype == np.int32
    _agree(got, cpnet["tile_labels"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pb.get_backend("torch", cellpose_ckpt=cpnet["ckpt"])


def test_wsi_nuclei_cli_equals_jax(dapi_slide, cpnet, tmp_path, monkeypatch):
    """The DAPI CLI end to end on a small pyramid: flow averaging over the
    classical segmenter (cellpose absent) writes the JAX script's pyramid
    bit for bit; ``--backend torch --cellpose_ckpt`` (``--device cpu``)
    writes labels in agreement with the JAX backend's plane, expanded and
    written by the JAX script's ``stream_labels_pyramid`` (the network's
    tiles at 64 px, batch 8, on both sides)."""
    def _no_cellpose(*a, **k):
        raise ImportError("cellpose absent")

    monkeypatch.setattr(jfw, "cellpose_flow_factory", _no_cellpose)
    monkeypatch.setattr(pfw, "cellpose_flow_factory", _no_cellpose)
    common = ["--halo", "32", "--target_mpp", "0", "--flow_averaging"]
    port_out, jax_out = tmp_path / "port.ome.tiff", tmp_path / "jax.ome.tiff"
    n = pwni.main(common + ["--slide_path", dapi_slide, "--tile_size", "96",
                            "--out_path", str(port_out)])
    monkeypatch.setattr(sys, "argv", ["wsi_nuclei_inference.py", "--slide_path", dapi_slide,
                                      "--tile_size", "96", "--out_path", str(jax_out)] + common)
    jwni.main()
    got = _read(port_out)
    np.testing.assert_array_equal(got, _read(jax_out))
    assert n == 5 and got.shape == (192, 192, 2)
    assert not list(tmp_path.glob("*.labels.raw")) and not (tmp_path / "flow_scratch").exists()

    torch_out, want_out = tmp_path / "torch.ome.tiff", tmp_path / "want.ome.tiff"
    factory = pfw.cellpose_torch_flow_factory
    monkeypatch.setattr(pfw, "cellpose_torch_flow_factory",
                        lambda *a, **k: factory(*a, tile=64, batch_size=8, **k))
    pwni.main(common + ["--slide_path", cpnet["slide"], "--tile_size", "128", "--backend",
                        "torch", "--cellpose_ckpt", cpnet["ckpt"], "--device", "cpu",
                        "--out_path", str(torch_out)])
    jwni.stream_labels_pyramid(cpnet["plane"], str(want_out), 0.325, 3.0)
    got, want = _read(torch_out), _read(want_out)
    _agree(got[..., 0], want[..., 0])
    with pytest.raises(SystemExit):
        pwni.main(["--slide_path", dapi_slide, "--backend", "torch",
                   "--out_path", str(tmp_path / "x.tiff")])


def test_he_nuclei_inference_equals_jax(tmp_path, monkeypatch):
    """``he_nuclei_inference`` end to end: the haematoxylin watershed (HED
    on a tensor, ``--device cpu``) and the HoverFast polygons (.json.gz)
    write the JAX script's pyramids bit for bit."""
    he = np.full((3, 192, 192), 235, np.uint8)
    yy, xx = np.mgrid[:192, :192]
    for cy, cx in [(48, 48), (48, 144), (144, 48), (144, 144), (96, 96)]:
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= 81
        he[0][blob], he[1][blob], he[2][blob] = 60, 50, 130
    slide = tmp_path / "he.tiff"
    write_pyramid(str(slide), he, n_levels=2, tile_size=64, mpp=0.5)
    feats = [{"geometry": {"coordinates": [[[60, 60], [90, 60], [90, 90], [60, 90]]]}},
             {"geometry": {"coordinates": [[[140, 70], [170, 70], [155, 100]]]}},
             {"geometry": {"coordinates": [[[90, 170], [110, 160], [125, 175], [115, 191],
                                            [95, 190]]]}}]
    pjson = tmp_path / "slide.json.gz"
    with gzip.open(pjson, "wt") as f:
        f.write(json.dumps(feats))
    cases = {"classical": ["--tile_size", "128", "--halo", "32"],
             "polygons": ["--polygons_json", str(pjson), "--expansion_px", "2.0",
                          "--tile_size", "64"]}
    for tag, extra in cases.items():
        port_out, jax_out = tmp_path / f"port_{tag}.tiff", tmp_path / f"jax_{tag}.tiff"
        n = phe.main(["--slide_path", str(slide), "--out_path", str(port_out), "--device", "cpu"]
                     + extra)
        monkeypatch.setattr(sys, "argv", ["he_nuclei_inference.py", "--slide_path", str(slide),
                                          "--out_path", str(jax_out)] + extra)
        jhe.main()
        got = _read(port_out)
        np.testing.assert_array_equal(got, _read(jax_out))
        assert n == got[..., 0].max() >= (4 if tag == "classical" else 3)
    tile = he[:, 32:96, 32:96].transpose(1, 2, 0).copy()
    np.testing.assert_array_equal(phe.hematoxylin_segment(tile, "cpu"),
                                  jhe.hematoxylin_segment(tile))
