"""The port's records, image transforms and datasets, profiler and summary
writer against the JAX package's (``data/records.py``, ``data/vision.py``,
``utils/profiler.py``, ``utils/summary.py``).

Files and bytes are held exactly: record files and ``encode_example``
byte for byte (and each package reads the other's), the errors' texts,
every transform's output bit for bit under one ``np.random.Generator``
seed (``Resize`` on both branches: PIL, and the numpy fallback with
``HAVE_PIL`` patched off in both packages), the datasets' items, the
profiler's table format and ``memory_analysis``'s keys and argument /
output bytes, and summary files read across packages (equal but for
``ts``).
"""

import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from of_spmm_tpu.data import dataset as jdataset
from of_spmm_tpu.data import records as jrec
from of_spmm_tpu.data import vision as jvis
from of_spmm_tpu.utils import profiler as jprof
from of_spmm_tpu.utils import summary as jsum
from of_spmm_tpu_torch.data import DataLoader, records, vision
from of_spmm_tpu_torch.utils import SummaryWriter, profiler, read_events, summary

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

# -- records ------------------------------------------------------------------------

EXAMPLES = [
    {"image": np.arange(24, dtype=np.uint8).reshape(2, 4, 3), "label": 7},
    {"x": np.linspace(0, 1, 5), "ids": [3, -1, 2**40], "raw": b"\x00\xffabc", "empty": []},
    {"scalar_f": 2.5, "m": np.ones((2, 0, 3), np.float64), "bytes2": bytearray(b"zz")},
]


@pytest.mark.parametrize("i", range(len(EXAMPLES)))
def test_encode_example_bytes_and_decode_match_jax(i):
    ex = EXAMPLES[i]
    got, want = records.encode_example(ex), jrec.encode_example(ex)
    assert got == want
    a, b = records.decode_example(want), jrec.decode_example(got)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], bytes):
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bad", [np.asarray(["a", "b"]), np.asarray([True, False]),
                                 np.asarray([1 + 2j])])
def test_unsupported_dtype_type_error_matches_jax(bad):
    msgs = []
    for mod in (records, jrec):
        with pytest.raises(TypeError, match="unsupported feature dtype") as err:
            mod.encode_example({"f": bad})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _write(mod, path, n, raw=True):
    """n seeded image examples (raw bytes, shape, label) and, with ``raw``,
    one payload that is not an example."""
    rng = np.random.default_rng(3)
    with mod.RecordWriter(str(path)) as w:
        for i in range(n):
            w.write_example({"img": rng.integers(0, 256, (4, 5, 3)).astype(np.uint8).tobytes(),
                             "shape": [4, 5, 3], "label": i})
        if raw:
            w.write(b"raw payload")


def test_record_files_byte_equal_and_cross_read(tmp_path):
    _write(records, tmp_path / "p.rec", 6)
    _write(jrec, tmp_path / "j.rec", 6)
    assert (tmp_path / "p.rec").read_bytes() == (tmp_path / "j.rec").read_bytes()
    got = list(records.read_records(str(tmp_path / "j.rec")))
    assert got == list(jrec.read_records(str(tmp_path / "p.rec")))
    assert len(got) == 7 and got[-1] == b"raw payload"


CORRUPT = {
    "header": lambda b: b + b"\x01\x02\x03",
    "body": lambda b: b[:-4],
    "crc": lambda b: b[:20] + bytes([b[20] ^ 1]) + b[21:],
}


@pytest.mark.parametrize("kind", list(CORRUPT))
def test_truncation_and_crc_errors_match_jax(tmp_path, kind):
    path = tmp_path / "r.rec"
    _write(records, path, 2)
    path.write_bytes(CORRUPT[kind](path.read_bytes()))
    msgs = []
    for mod in (records, jrec):
        with pytest.raises(IOError) as err:
            list(mod.read_records(str(path)))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    if kind == "crc":  # unverified, the flipped payload reads
        assert len(list(records.read_records(str(path), verify=False))) == 3


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 3), (2, 3)])
def test_record_dataset_rank_world_matches_jax(tmp_path, rank, world):
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.rec"))
        _write(records, paths[-1], 4 + i, raw=False)
    ds = records.RecordDataset(paths, rank=rank, world=world)
    jds = jrec.RecordDataset(paths, rank=rank, world=world)
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert sorted(a) == sorted(b) and a["img"] == b["img"]
        np.testing.assert_array_equal(a["label"], b["label"])
    raw = records.RecordDataset(paths[0], decode=False)
    assert raw[0] == jrec.RecordDataset(paths[0], decode=False)[0]


# -- image transforms ----------------------------------------------------------------

def _img(h=37, w=53, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


TRANSFORMS = {
    "resize_int": lambda m: m.Resize(24),
    "resize_hw": lambda m: m.Resize((20, 61)),
    "resize_same": lambda m: m.Resize((37, 53)),
    "center_crop": lambda m: m.CenterCrop(30),
    "random_crop": lambda m: m.RandomCrop(17),
    "random_resized_crop": lambda m: m.RandomResizedCrop(16),
    "random_resized_crop_fallback": lambda m: m.RandomResizedCrop(16, scale=(2.0, 3.0)),
    "flip": lambda m: m.RandomHorizontalFlip(),
    "normalize": lambda m: m.Normalize(),
    "compose": lambda m: m.Compose((m.RandomResizedCrop(32), m.RandomHorizontalFlip(),
                                    m.Normalize())),
}


@pytest.mark.parametrize("pil", [True, False])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_bit_equal_to_jax(monkeypatch, name, pil):
    if not pil:
        monkeypatch.setattr(vision, "HAVE_PIL", False)
        monkeypatch.setattr(jvis, "HAVE_PIL", False)
    t, jt = TRANSFORMS[name](vision), TRANSFORMS[name](jvis)
    for seed in range(4):
        x = _img(seed=seed)
        if getattr(t, "_random", False) or isinstance(t, vision.Compose):
            got = t(x, np.random.default_rng(seed))
            want = jt(x, np.random.default_rng(seed))
        else:
            got, want = t(x), jt(x)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_resize_branches_differ_and_transform_errors_match_jax(monkeypatch):
    x = _img()
    pil = vision.Resize(24)(x)
    monkeypatch.setattr(vision, "HAVE_PIL", False)
    assert not np.array_equal(pil, vision.Resize(24)(x))  # truncation, no antialias
    for t in (lambda m: m.CenterCrop(40)(x), lambda m: m.Normalize()(x[0])):
        msgs = []
        for m in (vision, jvis):
            with pytest.raises(ValueError) as err:
                t(m)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(RuntimeError, match="requires PIL"):
        vision.decode_image(b"")


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_decode_image_and_image_folder_match_jax(tmp_path):
    for c, n in (("cat", 2), ("dog", 3)):
        (tmp_path / c).mkdir()
        for i in range(n):
            (tmp_path / c / f"{i}.png").write_bytes(_png(_img(30 + i, 40, seed=i)))
        (tmp_path / c / "notes.txt").write_text("skip")
    data = (tmp_path / "dog" / "1.png").read_bytes()
    np.testing.assert_array_equal(vision.decode_image(data), jvis.decode_image(data))
    tf = lambda m: m.Compose((m.RandomCrop(24), m.RandomHorizontalFlip(), m.Normalize()))  # noqa
    ds = vision.ImageFolder(str(tmp_path), transform=tf(vision), seed=3)
    jds = jvis.ImageFolder(str(tmp_path), transform=tf(jvis), seed=3)
    assert ds.class_to_idx == jds.class_to_idx and ds.samples == jds.samples and len(ds) == 5
    for i in range(len(ds)):
        (a, la), (b, lb) = ds[i], jds[i]
        np.testing.assert_array_equal(a, b)
        assert la == lb and la.dtype == lb.dtype
    (tmp_path / "empty").mkdir()
    msgs = []
    for m in (vision, jvis):
        with pytest.raises(ValueError) as err:
            m.ImageFolder(str(tmp_path / "empty"))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_coco_detection_and_collate_match_jax(tmp_path):
    ann = {"images": [{"id": 4, "file_name": "a.png"}, {"id": 2, "file_name": "b.png"}],
           "annotations": [{"image_id": 4, "bbox": [1, 2, 3, 4], "category_id": 7},
                           {"image_id": 4, "bbox": [0, 0, 5, 5], "category_id": 1},
                           {"image_id": 9, "bbox": [0, 0, 1, 1], "category_id": 3}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    (tmp_path / "a.png").write_bytes(_png(_img(20, 20, seed=1)))
    (tmp_path / "b.png").write_bytes(_png(_img(20, 20, seed=2)))
    ds = vision.CocoDetection(str(tmp_path), str(tmp_path / "ann.json"),
                              transform=vision.CenterCrop(16))
    jds = jvis.CocoDetection(str(tmp_path), str(tmp_path / "ann.json"),
                             transform=jvis.CenterCrop(16))
    items, jitems = [ds[i] for i in range(len(ds))], [jds[i] for i in range(len(jds))]
    for a, b in zip(items, jitems):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    got, want = vision.detection_collate(items), jvis.detection_collate(jitems)
    np.testing.assert_array_equal(got[0], want[0])
    for u, v in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(u, v)


class _Decoded:
    """Record examples decoded to (image, label) through a seeded transform,
    over either package's RecordDataset and transforms."""

    def __init__(self, rec, vis, paths):
        self.ds = rec.RecordDataset(paths)
        self.tf = vis.Compose((vis.RandomResizedCrop(8), vis.RandomHorizontalFlip(),
                               vis.Normalize()))

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        ex = self.ds[i]
        img = np.frombuffer(ex["img"], np.uint8).reshape(tuple(ex["shape"]))
        return self.tf(img, np.random.default_rng(i)), np.int64(ex["label"])


def test_loader_over_records_matches_jax(tmp_path):
    path = str(tmp_path / "d.rec")
    _write(records, path, 9, raw=False)
    kw = dict(batch_size=4, shuffle=True, seed=5, prefetch=0)
    got = list(DataLoader(_Decoded(records, vision, [path]), **kw))
    want = list(jdataset.DataLoader(_Decoded(jrec, jvis, [path]), **kw))
    assert len(got) == len(want) == 3
    for (x, y), (jx, jy) in zip(got, want):
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y.numpy(), jy)


# -- profiler -------------------------------------------------------------------------

def test_profiler_ranges_nest_and_key_averages_format_match_jax():
    shapes = []
    for mod in (profiler, jprof):
        mod.range_push("outside")
        mod.range_pop()
        with mod.profile() as prof:
            with mod.record("step"):
                with mod.record("inner"):
                    pass
                with mod.record("inner"):
                    pass
        shapes.append([(e.name, e.depth) for e in prof.events])
        # the table of fixed events: the same text in both packages
        prof.events = [mod.Event("lookup", 0.0, 0.0015, 0), mod.Event("update", 0.0, 0.25, 1),
                       mod.Event("lookup", 1.0, 1.0025, 0)]
        shapes.append(prof.key_averages())
        assert prof.events[0].duration_ms == pytest.approx(1.5)
    assert shapes[0] == shapes[2] == [("inner", 1), ("inner", 1), ("step", 0)]
    assert shapes[1] == shapes[3]
    assert shapes[1].splitlines()[0].split() == ["name", "count", "total", "ms", "avg", "ms",
                                                 "max", "ms"]


def test_profiler_trace_captures_the_ranges_on_the_cpu(tmp_path):
    a = torch.randn(16, 16)
    with profiler.trace(str(tmp_path / "tr")):
        with profiler.record("port_range"):
            (a @ a).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.loads((tmp_path / "tr" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "port_range" for e in events)


def test_memory_analysis_keys_and_bytes_match_jax():
    a = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    fn = lambda x: (x @ x).sum(0)  # noqa: E731
    want = jprof.memory_analysis(fn, jnp.asarray(a))
    got = profiler.memory_analysis(fn, torch.from_numpy(a))
    assert sorted(got) == sorted(want)
    assert (got["argument"], got["output"]) == (want["argument"], want["output"]) == (16384, 256)
    for m in (got, want):
        assert m["peak"] == m["argument"] + m["output"] + m["temp"]
    assert got["temp"] >= 16384 and got["alias"] == 0  # x @ x is held while summed
    same = profiler.memory_analysis(lambda x: x, torch.from_numpy(a))
    assert same["alias"] == same["output"] == 16384 and same["temp"] == 0


# -- summary --------------------------------------------------------------------------

def _log(mod, d, value_of):
    with mod.SummaryWriter(str(d)) as w:
        assert mod is jsum or isinstance(w, SummaryWriter)
        w.add_scalar("loss", value_of(0.75), step=3)
        w.add_scalars("eval", {"acc": value_of(0.5), "f1": 0.25}, step=np.int64(4))
        w.add_text("note", "hello", step=5)
        w.add_scalar("lr", 1e-3)


def test_summary_files_cross_read_with_jax(tmp_path):
    _log(jsum, tmp_path / "j", float)
    _log(summary, tmp_path / "p", torch.tensor)
    got, want = jsum.read_events(str(tmp_path / "p")), read_events(str(tmp_path / "j"))
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"} for e in evs]  # noqa
    assert strip(got) == strip(want) and len(got) == 5
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    assert re.fullmatch(r"\{\"ts\": [0-9.e+-]+, \"step\": 3, \"tag\": \"loss\", \"value\": 0.75\}",
                        (tmp_path / "p" / "events.jsonl").read_text().splitlines()[0])
