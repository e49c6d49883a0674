"""The port's data path (nans_clip_tpu_torch/data/npack.py, lmdb_store.py,
dataset.py, preprocess/lmdb_to_npack.py) against the JAX package's, on
seeded noise JPEGs of 48-64 pixels.

Everything here is exact: pack and LMDB files byte for byte, ids and
tokens, and uint8 pixels bit for bit. The port's default decoder is held
against the JAX reader's PIL path (``NPackReader(native=False)``, what the
JAX loader runs where its native decoder cannot build); ``exact_decode``
against the JAX exact path as the JAX loader runs it, which is PIL-bit-exact
(tests/test_native_decode.py)."""

import io
import os
import pickle
import threading
import time

import numpy as np
import pytest

from nans_clip_tpu.data import dataset as jdataset
from nans_clip_tpu.data import lmdb_store as jlmdb
from nans_clip_tpu.data import npack as jnpack
from nans_clip_tpu.preprocess import lmdb_to_npack as jconvert
from nans_clip_tpu_torch.data import dataset, lmdb_store, npack
from nans_clip_tpu_torch.preprocess import lmdb_to_npack


def _jpeg(rs, size=64):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 255, (size, size, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """10 images (image 3 corrupt), 7 captions of two images each: 14 pairs."""
    root = tmp_path_factory.mktemp("split")
    rs = np.random.RandomState(0)
    with npack.NPackWriter(str(root / "imgs.npack")) as w:
        for i in range(10):
            w.put(i, b"not a jpeg" if i == 3 else _jpeg(rs, 48 + 2 * i))
    with npack.NPackWriter(str(root / "pairs.npack")) as w:
        k = 0
        for t in range(7):
            for image_id in (t, (t + 1) % 10):
                w.put(k, npack.encode_pair(image_id, t, f"南宋“古籍”第{t}卷 ABC"))
                k += 1
    return str(root)


def test_npack_files_are_byte_equal_and_cross_read(tmp_path):
    records = [(5, b"five"), (1, b"one"), (99, b"ninety-nine" * 3), (7, b"")]
    ours, theirs = str(tmp_path / "port.npack"), str(tmp_path / "jax.npack")
    for writer, path in ((npack.NPackWriter, ours), (jnpack.NPackWriter, theirs)):
        with writer(path) as w:
            for k, v in records:
                w.put(k, v)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for reader in (npack.NPackReader(theirs), jnpack.NPackReader(ours, native=False),
                   jnpack.NPackReader(ours)):
        assert len(reader) == 4 and [k for k, _ in reader] == [1, 5, 7, 99]
        for k, v in records:
            assert bytes(reader.get(k)) == v
        assert reader.get(2) is None
        reader.close()
    with pytest.raises(ValueError, match="duplicate key"):
        with npack.NPackWriter(str(tmp_path / "dup.npack")) as w:
            w.put(1, b"a")
            w.put(1, b"b")
    raw = npack.encode_pair(12, 34, "南宋“古籍”")
    assert raw == jnpack.encode_pair(12, 34, "南宋“古籍”")
    assert npack.decode_pair(raw) == jnpack.decode_pair(raw) == (12, 34, "南宋“古籍”")


def test_lmdb_files_cross_read_and_round_trip(tmp_path):
    rs = np.random.RandomState(1)
    items = {f"{i:05d}".encode(): rs.bytes(int(rs.randint(1, 5000))) for i in range(300)}
    items[b"big"] = rs.bytes(20000)                 # an overflow run
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    lmdb_store.write_lmdb(ours, items)
    jlmdb.write_lmdb(theirs, items)
    assert open(os.path.join(ours, "data.mdb"), "rb").read() == \
        open(os.path.join(theirs, "data.mdb"), "rb").read()
    for reader in (lmdb_store.LMDBReader(theirs), jlmdb.LMDBReader(ours)):
        assert {k: bytes(v) for k, v in reader.items()} == items
        reader.close()
    # the compat environment: a write through the port, read back by both
    env = lmdb_store.open(str(tmp_path / "env"))
    with env.begin(write=True) as txn:
        txn.put(b"a", b"1")
        txn.put(b"num_samples", b"1")
    env.close()
    for reader in (lmdb_store.LMDBReader(str(tmp_path / "env")),
                   jlmdb.LMDBReader(str(tmp_path / "env"))):
        assert reader.get(b"a") == b"1" and reader.get(b"missing") is None
        reader.close()
    assert lmdb_store.verify(ours)["entries"] == jlmdb.verify(ours)["entries"] == len(items)


def _lmdb_split(root, rs):
    """A split in the reference's LMDB layout (preprocess/build_lmdb_dataset.py):
    pickled (image_id, text_id, text) under "idx", base64 JPEGs under the
    image id, and the two count keys."""
    import base64
    imgs = {str(i).encode(): base64.urlsafe_b64encode(_jpeg(rs, 48)) for i in range(6)}
    imgs[b"num_images"] = b"6"
    pairs = {}
    for t in range(4):
        for j, image_id in enumerate((t, (t + 1) % 6)):
            pairs[str(2 * t + j).encode()] = pickle.dumps((image_id, t, f"南宋古籍第{t}卷"))
    pairs[b"num_samples"] = str(len(pairs)).encode()
    jlmdb.write_lmdb(os.path.join(root, "imgs"), imgs)
    jlmdb.write_lmdb(os.path.join(root, "pairs"), pairs)


def test_lmdb_split_converts_to_the_same_npack(tmp_path):
    rs = np.random.RandomState(2)
    _lmdb_split(str(tmp_path / "lmdb"), rs)
    meta = lmdb_to_npack.convert_split(str(tmp_path / "lmdb"), str(tmp_path / "port"))
    jmeta = jconvert.convert_split(str(tmp_path / "lmdb"), str(tmp_path / "jax"))
    assert meta == jmeta and meta["num_samples"] == 8 and meta["num_images"] == 6
    for name in ("imgs.npack", "pairs.npack"):
        assert open(tmp_path / "port" / name, "rb").read() == \
            open(tmp_path / "jax" / name, "rb").read(), name
    # PairDataset converts an LMDB split in place on first use
    ds = dataset.PairDataset(str(tmp_path / "lmdb"))
    assert len(ds) == 8 and ds.get_pair(3) == (2, 1, "南宋古籍第1卷")


def _batches(loader, epochs, start):
    out = []
    for e in range(epochs):
        loader.set_epoch(e, start_batch=start if e == epochs - 1 else 0)
        out += [b for b in loader]
    return out


@pytest.mark.parametrize("exact", [False, True], ids=["bilinear", "exact"])
def test_loader_matches_jax(split, exact):
    """Two epochs (the second from batch 1), two processes, one corrupt
    JPEG resampled: ids, tokens and uint8 pixels equal to the JAX loader's."""
    failures = []
    for proc in range(2):
        kw = dict(batch_size=3, decode_size=40, context_length=16, shuffle=True, seed=7,
                  process_index=proc, process_count=2, num_threads=3, exact_decode=exact)
        ours = dataset.DataLoader(dataset.PairDataset(split), **kw)
        jds = jdataset.PairDataset(split)
        if not exact:
            jds.imgs = jnpack.NPackReader(os.path.join(split, "imgs.npack"), native=False)
        theirs = jdataset.DataLoader(jds, **kw)
        assert (ours.num_batches, ours.num_samples) == (theirs.num_batches, theirs.num_samples)
        got, want = _batches(ours, 2, 1), _batches(theirs, 2, 1)
        assert len(got) == len(want) == 2 * ours.num_batches - 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.image_ids, b.image_ids)
            np.testing.assert_array_equal(a.text_ids, b.text_ids)
            np.testing.assert_array_equal(a.texts, b.texts)
            assert a.images.dtype == b.images.dtype == np.uint8
            np.testing.assert_array_equal(a.images, b.images)
            assert 3 not in a.image_ids.tolist()
        assert ours.decode_failures == theirs.decode_failures
        failures.append(ours.decode_failures)
    assert sum(failures) > 0       # the corrupt image was drawn, and resampled


def test_loader_skips_without_decoding_and_stops_its_thread(split):
    loader = dataset.DataLoader(dataset.PairDataset(split), batch_size=4, decode_size=32,
                                seed=3, num_threads=2)
    loader.set_epoch(1)
    full = [b.text_ids for b in loader]
    calls = []
    orig = loader._make_batch
    loader._make_batch = lambda idx: calls.append(1) or orig(idx)
    loader.set_epoch(1, start_batch=2)
    tail = [b.text_ids for b in loader]
    assert len(calls) == len(tail) == len(full) - 2
    np.testing.assert_array_equal(np.concatenate(tail), np.concatenate(full[2:]))
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()                      # a consumer that leaves mid-epoch
    deadline = time.time() + 5
    while threading.active_count() >= before + 1 and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_decoders_decode_as_pil(tmp_path):
    """Each decoder is PIL's: the bilinear one converts then resizes, the
    exact one resizes (bicubic) then converts; a missing or corrupt record
    is a zero image with ok False."""
    from PIL import Image
    rs = np.random.RandomState(4)
    raw = _jpeg(rs, 50)
    path = str(tmp_path / "i.npack")
    with npack.NPackWriter(path) as w:
        w.put(1, raw)
        w.put(2, b"corrupt")
    r = npack.NPackReader(path)
    img = Image.open(io.BytesIO(raw))
    for decode, want in (
            (r.decode_jpeg_batch, img.convert("RGB").resize((24, 24), Image.BILINEAR)),
            (r.decode_jpeg_batch_pil, img.resize((24, 24), Image.BICUBIC).convert("RGB"))):
        out, ok = decode(np.array([1, 2, 3], np.uint64), 24, num_threads=2)
        assert ok.tolist() == [True, False, False]
        np.testing.assert_array_equal(out[0], np.asarray(want))
        assert not out[1:].any()
    r.close()
