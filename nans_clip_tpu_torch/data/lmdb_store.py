"""LMDB on-disk format, without liblmdb: a copy of the JAX package's
pure-Python reader and writer (``nans_clip_tpu/data/lmdb_store.py``, which
imports no JAX; the port keeps its own copy rather than import that
package).

The reference stores every dataset split in two LMDB environments
(training/data.py:49-56, preprocess/build_lmdb_dataset.py:43-95). This
module reads and writes the data file format of mdb.c itself:

* file = 4096-byte pages; pages 0/1 are meta pages (the one with the larger
  txnid and valid magic 0xBEEFC0DE wins);
* MDB_page header (16 bytes): pgno u64, pad u16, flags u16
  (1=branch 2=leaf 4=overflow 8=meta), lower u16 / upper u16 (or, for
  overflow pages, page-count u32); node offsets (u16 each, relative to the
  page start) grow up from byte 16, node bodies grow down from ``upper``;
* node (8-byte header): lo u16, hi u16, flags u16, ksize u16, key bytes,
  then data. Leaf: data size = lo | hi<<16; flag 1 (F_BIGDATA) means the
  "data" is a u64 page number of an overflow run. Branch: child page =
  lo | hi<<16 | flags<<32, and node 0's key is ignored by search;
* MDB_meta (at byte 16 of a meta page): magic u32, version u32 (=1),
  address u64, mapsize u64, two 48-byte MDB_db structs (free DB + main DB;
  the free DB's ``pad`` field doubles as the page size), last_pg u64,
  txnid u64. MDB_db: pad u32, flags u16, depth u16, branch/leaf/overflow
  page counts u64, entries u64, root u64 (0xFFFF.. = empty).

Reads are zero-copy over ``mmap``. Writes rebuild the B-tree bottom-up
(bulk load) on each commit: dataset construction and test fixtures.
``verify()`` (CLI: ``python -m nans_clip_tpu_torch.data.lmdb_store verify
FILE``) is a structural self-check for files from other writers. DUPSORT
sub-databases, which CN-CLIP datasets do not use, are not read.
"""

from __future__ import annotations

import builtins
import mmap
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

PSIZE = 4096
PAGEHDRSZ = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF
MAXKEYSIZE = 511
# data this large goes to overflow pages (mdb.c me_nodemax for 4K pages)
NODEMAX = ((PSIZE - PAGEHDRSZ) // 2) & ~1  # 2040

_PAGEHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_OVHDR = struct.Struct("<QHHI")             # pgno, pad, flags, page-count
_NODEHDR = struct.Struct("<HHHH")           # lo, hi, flags, ksize
_DB = struct.Struct("<IHHQQQQQ")            # pad, flags, depth, branch, leaf,
                                            # overflow, entries, root
_META_HEAD = struct.Struct("<IIQQ")         # magic, version, address, mapsize
_META_TAIL = struct.Struct("<QQ")           # last_pg, txnid


class LMDBError(Exception):
    pass


def _even(n: int) -> int:
    return (n + 1) & ~1


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class LMDBReader:
    """Read-only view of one LMDB data file (the main DB's B-tree)."""

    def __init__(self, path: str):
        """``path``: an LMDB directory (containing data.mdb) or a data file."""
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = builtins.open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self.psize, _flags, self.depth, self.branch_pages, self.leaf_pages,
         self.overflow_pages, self.entries, self.root) = meta

    def _read_meta_raw(self, byte_off: int):
        off = byte_off + PAGEHDRSZ
        if off + _META_HEAD.size + 2 * _DB.size + _META_TAIL.size > len(self._mm):
            return None
        magic, version, _addr, _mapsize = _META_HEAD.unpack_from(self._mm, off)
        if magic != MDB_MAGIC or version not in (MDB_VERSION, 999):
            return None
        free_db = _DB.unpack_from(self._mm, off + _META_HEAD.size)
        main_db = _DB.unpack_from(self._mm, off + _META_HEAD.size + _DB.size)
        last_pg, txnid = _META_TAIL.unpack_from(
            self._mm, off + _META_HEAD.size + 2 * _DB.size)
        return {"txnid": txnid, "free_db": free_db, "main_db": main_db,
                "last_pg": last_pg, "psize": free_db[0] or PSIZE}

    def _read_meta(self, byte_off: int):
        m = self._read_meta_raw(byte_off)
        if m is None:
            return None
        return m["txnid"], (m["psize"],) + m["main_db"][1:]

    def _live_meta(self) -> dict:
        """The live meta page, RAW — the one true pick used by the reader
        and the verifier (mdb.c tie-break: meta 0 wins equal txnids).
        Meta 0 is always at byte 0; meta 1 sits at the file's ACTUAL page
        size (recorded in meta 0's free-DB md_pad), which is the host's
        OS page size at creation time — 16K/64K files from e.g. aarch64
        hosts put meta 1 well past the 4K default."""
        m0 = self._read_meta_raw(0)
        if m0 is not None:
            m1 = self._read_meta_raw(m0["psize"])
        else:
            m1 = None
            for ps in (PSIZE, 8192, 16384, 32768, 65536):
                m1 = self._read_meta_raw(ps)
                if m1 is not None:
                    break
        if m0 is None and m1 is None:
            raise LMDBError(f"{self.path}: no valid LMDB meta page")
        if m0 is None:
            return m1
        if m1 is None or m0["txnid"] >= m1["txnid"]:
            return m0
        return m1

    def _pick_meta(self):
        m = self._live_meta()
        return (m["psize"],) + m["main_db"][1:]

    def _page(self, pgno: int) -> memoryview:
        off = pgno * self.psize
        return memoryview(self._mm)[off:off + self.psize]

    def _nodes(self, page: memoryview):
        _pgno, _pad, flags, lower, upper = _PAGEHDR.unpack_from(page, 0)
        nkeys = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ)
        return flags, ptrs

    def _node(self, page: memoryview, off: int):
        lo, hi, flags, ksize = _NODEHDR.unpack_from(page, off)
        key = bytes(page[off + 8:off + 8 + ksize])
        return lo, hi, flags, ksize, key

    def _leaf_value(self, page: memoryview, off: int) -> bytes:
        lo, hi, flags, ksize, _ = self._node(page, off)
        dsize = lo | (hi << 16)
        dstart = off + 8 + ksize
        if flags & F_BIGDATA:
            (ovpgno,) = struct.unpack_from("<Q", page, dstart)
            start = ovpgno * self.psize + PAGEHDRSZ
            return bytes(self._mm[start:start + dsize])
        return bytes(page[dstart:dstart + dsize])

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(64):  # depth bound
            page = self._page(pgno)
            flags, ptrs = self._nodes(page)
            if flags & P_LEAF:
                lo_i, hi_i = 0, len(ptrs) - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k = self._node(page, ptrs[mid])[4]
                    if k == key:
                        return self._leaf_value(page, ptrs[mid])
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: rightmost child whose (lower-bound) key <= target;
            # node 0's key is never compared (mdb_node_search starts at 1)
            lo_i, hi_i, best = 1, len(ptrs) - 1, 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                k = self._node(page, ptrs[mid])[4]
                if k <= key:
                    best = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            lo, hi, nflags, _, _ = self._node(page, ptrs[best])
            pgno = lo | (hi << 16) | (nflags << 32)
        raise LMDBError("B-tree deeper than 64 levels (corrupt file?)")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order (bytewise-sorted) iteration, like an LMDB cursor."""
        if self.root == P_INVALID:
            return
        stack = [(self.root, 0)]
        while stack:
            pgno, idx = stack.pop()
            page = self._page(pgno)
            flags, ptrs = self._nodes(page)
            if flags & P_LEAF:
                for off in ptrs:
                    yield self._node(page, off)[4], self._leaf_value(page, off)
                continue
            if idx < len(ptrs):
                stack.append((pgno, idx + 1))
                lo, hi, nflags, _, _ = self._node(page, ptrs[idx])
                stack.append((lo | (hi << 16) | (nflags << 32), 0))

    def __len__(self) -> int:
        return self.entries

    def close(self):
        self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------------
# Writer (bulk bottom-up B-tree build)
# ---------------------------------------------------------------------------

def write_lmdb(path: str, items: Dict[bytes, bytes], map_size: int = 0,
               txnid: int = 1) -> None:
    """Write ``items`` as a complete LMDB data file (atomic rewrite).

    ``path``: LMDB directory (data.mdb is created inside) or a file path.
    """
    if not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    ordered = sorted(items.items())
    for k, _ in ordered:
        if not 0 < len(k) <= MAXKEYSIZE:
            raise LMDBError(f"bad key length {len(k)}")

    pages: list = [None, None]  # meta slots; data pages from pgno 2

    def alloc(n: int = 1) -> int:
        pgno = len(pages)
        pages.extend([None] * n)
        return pgno

    n_overflow = 0

    def build_leaf_nodes():
        """Pack items into leaf pages; returns [(first_key, pgno)]."""
        nonlocal n_overflow
        level = []
        buf_nodes, used = [], 0
        space = PSIZE - PAGEHDRSZ

        def flush():
            nonlocal buf_nodes, used
            if not buf_nodes:
                return
            pgno = alloc()
            pages[pgno] = _pack_page(pgno, P_LEAF, buf_nodes)
            level.append((buf_nodes[0][1], pgno))
            buf_nodes, used = [], 0

        for key, val in ordered:
            if 8 + len(key) + len(val) > NODEMAX:
                ovpages = -(-(PAGEHDRSZ + len(val)) // PSIZE)
                ovpgno = alloc(ovpages)
                blob = bytearray(ovpages * PSIZE)
                _OVHDR.pack_into(blob, 0, ovpgno, 0, P_OVERFLOW, ovpages)
                blob[PAGEHDRSZ:PAGEHDRSZ + len(val)] = val
                pages[ovpgno] = bytes(blob)
                n_overflow += ovpages
                node = _node_bytes(len(val), F_BIGDATA, key,
                                   struct.pack("<Q", ovpgno))
            else:
                node = _node_bytes(len(val), 0, key, val)
            cost = _even(len(node)) + 2
            if used + cost > space:
                flush()
            buf_nodes.append((node, key))
            used += cost
        flush()
        return level

    def build_branch_level(children):
        """children: [(first_key, pgno)] -> parent level of the same form."""
        level = []
        buf_nodes, used = [], 0
        space = PSIZE - PAGEHDRSZ

        def flush():
            nonlocal buf_nodes, used
            if not buf_nodes:
                return
            pgno = alloc()
            pages[pgno] = _pack_page(pgno, P_BRANCH, buf_nodes)
            level.append((buf_nodes[0][1], pgno))
            buf_nodes, used = [], 0

        for first_key, child_pgno in children:
            lo = child_pgno & 0xFFFF
            hi = (child_pgno >> 16) & 0xFFFF
            fl = (child_pgno >> 32) & 0xFFFF
            node = _NODEHDR.pack(lo, hi, fl, len(first_key)) + first_key
            cost = _even(len(node)) + 2
            if used + cost > space:
                flush()
            buf_nodes.append((node, first_key))
            used += cost
        flush()
        return level

    depth, n_branch = 0, 0
    if ordered:
        level = build_leaf_nodes()
        n_leaf = len(level)
        depth = 1
        while len(level) > 1:
            level = build_branch_level(level)
            n_branch += len(level)
            depth += 1
        root = level[0][1]
    else:
        root, n_leaf = P_INVALID, 0

    last_pg = len(pages) - 1
    file_len = len(pages) * PSIZE
    mapsize = max(map_size, file_len, 1 << 20)

    main_db = _DB.pack(0, 0, depth, n_branch, n_leaf, n_overflow,
                       len(ordered), root)
    free_db = _DB.pack(PSIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
    meta = (_META_HEAD.pack(MDB_MAGIC, MDB_VERSION, 0, mapsize)
            + free_db + main_db + _META_TAIL.pack(last_pg, txnid))
    for slot in (0, 1):
        page = bytearray(PSIZE)
        _PAGEHDR.pack_into(page, 0, slot, 0, P_META, 0, 0)
        page[PAGEHDRSZ:PAGEHDRSZ + len(meta)] = meta
        pages[slot] = bytes(page)

    tmp = path + ".tmp"
    with builtins.open(tmp, "wb") as f:
        i = 0
        while i < len(pages):
            p = pages[i]
            f.write(p)
            i += len(p) // PSIZE
    os.replace(tmp, path)


def _node_bytes(dsize: int, flags: int, key: bytes, data: bytes) -> bytes:
    return _NODEHDR.pack(dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                         flags, len(key)) + key + data


def _pack_page(pgno: int, flags: int, nodes) -> bytes:
    """nodes: [(node_bytes, key)] in sorted order. Bodies grow down from
    the page end, offsets grow up from the header — the LMDB layout."""
    page = bytearray(PSIZE)
    upper = PSIZE
    offsets = []
    for node, _ in nodes:
        upper -= _even(len(node))
        page[upper:upper + len(node)] = node
        offsets.append(upper)
    lower = PAGEHDRSZ + 2 * len(nodes)
    if lower > upper:
        raise LMDBError("page overflow during pack (bug)")
    _PAGEHDR.pack_into(page, 0, pgno, 0, flags, lower, upper)
    struct.pack_into(f"<{len(nodes)}H", page, PAGEHDRSZ, *offsets)
    return bytes(page)


# ---------------------------------------------------------------------------
# ``lmdb`` package compatible API (the surface the reference uses:
# open/begin/get/put/commit/cursor/stat/close — training/data.py:49-56,
# eval/data.py:60-64, preprocess/build_lmdb_dataset.py:50-95)
# ---------------------------------------------------------------------------

class Cursor:
    def __init__(self, pairs: Iterator[Tuple[bytes, bytes]], buffers: bool):
        self._pairs = pairs
        self._buffers = buffers

    def __iter__(self):
        for k, v in self._pairs:
            if self._buffers:
                yield memoryview(k), memoryview(v)
            else:
                yield k, v


class Transaction:
    def __init__(self, env: "Environment", write: bool, buffers: bool):
        self._env = env
        self._write = write
        self._buffers = buffers
        self._pending: Dict[bytes, bytes] = {}
        # Deletes are staged HERE, not on the environment: an aborted
        # transaction's deletes must vanish, and uncommitted deletes must
        # be invisible to other transactions (real lmdb isolation).
        self._dels: set = set()
        self._done = False

    def get(self, key: bytes, default=None):
        key = bytes(key)
        val = self._pending.get(key)
        if val is None and key not in self._dels:
            val = self._env._get(key)
        if val is None:
            return default
        return memoryview(val) if self._buffers else val

    def put(self, key: bytes, value: bytes, **_kw) -> bool:
        if not self._write:
            raise LMDBError("put() on a read-only transaction")
        key = bytes(key)
        self._dels.discard(key)
        self._pending[key] = bytes(value)
        return True

    def delete(self, key: bytes) -> bool:
        if not self._write:
            raise LMDBError("delete() on a read-only transaction")
        key = bytes(key)
        existed = (key in self._pending) or (
            key not in self._dels and self._env._get(key) is not None)
        self._pending.pop(key, None)
        self._dels.add(key)
        return existed

    def cursor(self) -> Cursor:
        return Cursor(self._env._items_merged(self._pending, self._dels),
                      self._buffers)

    def stat(self) -> dict:
        n = self._env._entries()
        n -= sum(1 for k in self._dels if self._env._get(k) is not None)
        n += sum(1 for k in self._pending if self._env._get(k) is None)
        return {"entries": n, "psize": self._env._reader.psize, "depth": 0,
                "branch_pages": 0, "leaf_pages": 0, "overflow_pages": 0}

    def commit(self):
        if self._done:
            return
        self._done = True
        if self._write and (self._pending or self._dels):
            self._env._commit(self._pending, self._dels)

    def abort(self):
        self._done = True
        self._pending.clear()
        self._dels.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None and self._write:
            self.commit()
        else:
            self.abort()
        return False


class Environment:
    def __init__(self, path: str, map_size: int, readonly: bool,
                 create: bool, subdir: bool):
        self._dir = path if subdir else os.path.dirname(path)
        self._data_path = os.path.join(path, "data.mdb") if subdir else path
        self._map_size = map_size
        self._readonly = readonly
        self._reader: Optional[LMDBReader] = None
        self._staged: Optional[Dict[bytes, bytes]] = None  # write-side cache
        self._txnid = 0
        self._dirty = False
        exists = os.path.exists(self._data_path)
        if not exists:
            if readonly or not create:
                raise LMDBError(f"No such LMDB environment: {path}")
            if subdir:
                os.makedirs(path, exist_ok=True)
            write_lmdb(self._data_path, {}, map_size, txnid=0)
        self._open_reader()
        self._flushed_n = self._reader.entries

    # -- internals ----------------------------------------------------------
    def _open_reader(self):
        if self._reader is not None:
            self._reader.close()
        self._reader = LMDBReader(self._data_path)

    def _get(self, key: bytes) -> Optional[bytes]:
        if self._staged is not None:
            return self._staged.get(key)
        return self._reader.get(key)

    def _entries(self) -> int:
        if self._staged is not None:
            return len(self._staged)
        return self._reader.entries

    def _items_merged(self, pending: Dict[bytes, bytes], dels=()):
        if self._staged is not None:
            base: Dict[bytes, bytes] = dict(self._staged)
        else:
            base = dict(self._reader.items())
        for k in dels:
            base.pop(k, None)
        base.update(pending)
        return iter(sorted(base.items()))

    def _commit(self, pending: Dict[bytes, bytes], dels=()):
        if self._staged is None:
            self._staged = dict(self._reader.items())
        for k in dels:
            self._staged.pop(k, None)
        self._staged.update(pending)
        self._txnid += 1
        self._dirty = True
        # Amortized flush: rebuilding the whole file on EVERY commit makes
        # the reference's periodic-commit ingest (a commit every 1000-5000
        # puts, build_lmdb_dataset.py:70,88) quadratic in I/O. Reads stay
        # correct between flushes (the staged dict is authoritative);
        # sync()/close() always flush, so the file is complete on exit.
        # Trade-off vs real lmdb: commit durability becomes close()
        # durability — documented shim behavior.
        if len(self._staged) >= 2 * max(1, self._flushed_n):
            self._flush()

    def _flush(self):
        if not self._dirty:
            return
        write_lmdb(self._data_path, self._staged, self._map_size,
                   txnid=self._txnid)
        self._flushed_n = len(self._staged)
        self._dirty = False
        self._open_reader()

    # -- public surface -----------------------------------------------------
    def begin(self, write: bool = False, buffers: bool = False, **_kw) -> Transaction:
        if write and self._readonly:
            raise LMDBError("write transaction on read-only environment")
        return Transaction(self, write, buffers)

    def stat(self) -> dict:
        return {"entries": self._entries(), "psize": self._reader.psize,
                "depth": self._reader.depth,
                "branch_pages": self._reader.branch_pages,
                "leaf_pages": self._reader.leaf_pages,
                "overflow_pages": self._reader.overflow_pages}

    def sync(self, force: bool = True):
        self._flush()

    def close(self):
        if self._reader is not None:
            self._flush()
            self._reader.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open(path: str, map_size: int = 10 * 1024 * 1024, readonly: bool = False,
         create: bool = True, subdir: bool = True, lock: bool = True,
         readahead: bool = True, meminit: bool = True, max_readers: int = 126,
         max_dbs: int = 0, **_kw) -> Environment:
    """``lmdb.open`` twin (flags that are OS-tuning no-ops here are accepted
    and ignored)."""
    return Environment(path, map_size, readonly, create, subdir)


# ---------------------------------------------------------------------------
# Structural verifier (``python -m nans_clip_tpu_torch.data.lmdb_store verify F``)
# ---------------------------------------------------------------------------

def verify(path: str) -> dict:
    """Byte-layout self-check of one LMDB data file.

    Walks BOTH B-trees (main DB and free DB) from the live meta page and
    checks every invariant a real liblmdb reader relies on (mdb.c
    mdb_page_search / mdb_node_search assumptions):

    * page headers: stored pgno matches the file position, flags name
      exactly one page type, ``PAGEHDRSZ <= lower <= upper <= psize``;
    * node offsets point inside ``[upper, psize)`` and every node body
      (header + key + data) fits inside its page;
    * key sizes are in ``(0, MAXKEYSIZE]``; keys strictly increase within
      each page AND across the whole tree (cursor order = sorted order);
    * branch children: every child pgno <= last_pg; all leaves at one
      uniform depth equal to the meta's ``md_depth``;
    * overflow runs: header carries P_OVERFLOW + a page count that covers
      the node's data size, and the run lies inside the file;
    * page accounting: branch/leaf/overflow page counts and the entry
      count equal the MDB_db stats in the meta; no page is referenced
      twice (across metas, both trees, and overflow runs);
    * free-DB semantics: keys are u64 txnids, values are MDB_IDL arrays
      (count-prefixed u64 page lists) whose pages are in-file and not
      referenced by either tree.

    Returns a stats dict; raises :class:`LMDBError` on the first violation.
    """
    r = LMDBReader(path)
    try:
        psize = r.psize
        nodemax = ((psize - PAGEHDRSZ) // 2) & ~1
        file_pages = len(r._mm) // psize
        # the live meta — the SAME pick the reader makes (_live_meta:
        # version-checked, meta-0 tie-break), so the verifier can never
        # validate a different tree than the one a consumer walks
        live = r._live_meta()
        last_pg, free_db, main_db = (live["last_pg"], live["free_db"],
                                     live["main_db"])
        if last_pg >= file_pages:
            raise LMDBError(f"last_pg {last_pg} beyond file ({file_pages} pages)")

        seen: Dict[int, str] = {0: "meta", 1: "meta"}

        def claim(pgno: int, kind: str):
            if pgno > last_pg:
                raise LMDBError(f"{kind} page {pgno} beyond last_pg {last_pg}")
            if pgno in seen:
                raise LMDBError(
                    f"page {pgno} referenced twice ({seen[pgno]} and {kind})")
            seen[pgno] = kind

        def check_page(pgno: int):
            # bytes copy, not the mmap view: a raised LMDBError's traceback
            # would otherwise pin the view and break r.close() in `finally`
            page = bytes(r._page(pgno))
            hdr_pgno, _pad, flags, lower, upper = _PAGEHDR.unpack_from(page, 0)
            if hdr_pgno != pgno:
                raise LMDBError(f"page {pgno}: header pgno {hdr_pgno}")
            ptype = flags & (P_BRANCH | P_LEAF | P_OVERFLOW | P_META)
            if ptype not in (P_BRANCH, P_LEAF):
                raise LMDBError(f"page {pgno}: unexpected flags {flags:#x}")
            if not (PAGEHDRSZ <= lower <= upper <= psize):
                raise LMDBError(
                    f"page {pgno}: bad bounds lower={lower} upper={upper}")
            nkeys = (lower - PAGEHDRSZ) // 2
            ptrs = struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ)
            for o in ptrs:
                if not (upper <= o < psize):
                    raise LMDBError(f"page {pgno}: node offset {o} outside "
                                    f"[{upper}, {psize})")
            return page, ptype, ptrs

        stats = {t: {"branch": 0, "leaf": 0, "overflow": 0, "entries": 0}
                 for t in ("main", "free")}

        def walk(pgno: int, depth: int, tree: str, lo_key, hi_key,
                 leaf_depths: set):
            claim(pgno, tree)
            page, ptype, ptrs = check_page(pgno)
            if ptype == P_LEAF:
                stats[tree]["leaf"] += 1
                leaf_depths.add(depth)
                prev = None
                for o in ptrs:
                    lo, hi, nflags, ksize, key = r._node(page, o)
                    if not (0 < ksize <= MAXKEYSIZE):
                        raise LMDBError(f"page {pgno}: key size {ksize}")
                    dsize = lo | (hi << 16)
                    if prev is not None and key <= prev:
                        raise LMDBError(f"page {pgno}: keys out of order")
                    if lo_key is not None and key < lo_key:
                        raise LMDBError(f"page {pgno}: key below subtree bound")
                    if hi_key is not None and key >= hi_key:
                        raise LMDBError(f"page {pgno}: key above subtree bound")
                    prev = key
                    if nflags & F_BIGDATA:
                        if o + 8 + ksize + 8 > psize:
                            raise LMDBError(f"page {pgno}: bigdata node clipped")
                        (ovpgno,) = struct.unpack_from("<Q", page, o + 8 + ksize)
                        ovhdr = bytes(r._page(ovpgno))
                        ohp, _op, oflags, ocount = _OVHDR.unpack_from(ovhdr, 0)
                        if ohp != ovpgno or not (oflags & P_OVERFLOW):
                            raise LMDBError(
                                f"overflow page {ovpgno}: bad header")
                        need = -(-(PAGEHDRSZ + dsize) // psize)
                        if ocount < need:
                            raise LMDBError(
                                f"overflow run {ovpgno}: {ocount} pages < "
                                f"{need} needed for {dsize} bytes")
                        for i in range(ocount):
                            claim(ovpgno + i, "overflow")
                        stats[tree]["overflow"] += ocount
                    else:
                        if o + 8 + ksize + dsize > psize:
                            raise LMDBError(f"page {pgno}: node data clipped")
                    stats[tree]["entries"] += 1
                    if tree != "main":
                        # free-DB entry: txnid key, MDB_IDL data
                        if ksize != 8:
                            raise LMDBError(
                                f"free DB key size {ksize} != 8 (txnid)")
                        val = r._leaf_value(page, o)
                        if len(val) < 8 or len(val) % 8:
                            raise LMDBError("free DB value not a u64 IDL")
                        idl = struct.unpack(f"<{len(val) // 8}Q", val)
                        if idl[0] != len(idl) - 1:
                            raise LMDBError(
                                f"free DB IDL count {idl[0]} != {len(idl) - 1}")
                        for fp in idl[1:]:
                            claim(fp, "freed")
                return
            stats[tree]["branch"] += 1
            if len(ptrs) < 2:
                raise LMDBError(f"branch page {pgno}: {len(ptrs)} children")
            child_keys = [r._node(page, o)[4] for o in ptrs]
            for i in range(2, len(child_keys)):
                if child_keys[i] <= child_keys[i - 1]:
                    raise LMDBError(f"branch page {pgno}: separator keys "
                                    "out of order")
            for i, o in enumerate(ptrs):
                lo, hi, nflags, _, _ = r._node(page, o)
                child = lo | (hi << 16) | (nflags << 32)
                sub_lo = None if i == 0 else child_keys[i]
                sub_hi = (hi_key if i == len(ptrs) - 1
                          else child_keys[i + 1])
                walk(child, depth + 1, tree, sub_lo or lo_key, sub_hi,
                     leaf_depths)

        for name, db in (("free", free_db), ("main", main_db)):
            _pad, _fl, depth, n_branch, n_leaf, n_over, entries, root = db
            if root == P_INVALID:
                if entries or depth or n_branch or n_leaf:
                    raise LMDBError(f"{name} DB: empty root but nonzero stats")
                continue
            leaf_depths: set = set()
            walk(root, 1, name, None, None, leaf_depths)
            if len(leaf_depths) != 1:
                raise LMDBError(f"{name} DB: leaves at depths {leaf_depths}")
            if leaf_depths != {depth}:
                raise LMDBError(f"{name} DB: meta depth {depth}, actual "
                                f"{leaf_depths.pop()}")
            got = (stats[name]["branch"], stats[name]["leaf"],
                   stats[name]["overflow"], stats[name]["entries"])
            want = (n_branch, n_leaf, n_over, entries)
            if got != want:
                raise LMDBError(
                    f"{name} DB stats mismatch: meta {want} vs walked {got}")
        unreferenced = last_pg + 1 - len(seen)
        return {"psize": psize, "last_pg": last_pg,
                "entries": stats["main"]["entries"], "depth": main_db[2],
                "branch_pages": stats["main"]["branch"],
                "leaf_pages": stats["main"]["leaf"],
                "overflow_pages": stats["main"]["overflow"],
                "free_entries": stats["free"]["entries"],
                "freed_pages": sum(1 for v in seen.values() if v == "freed"),
                "unreferenced_pages": unreferenced}
    finally:
        r.close()


def _main(argv):
    import json as _json
    import sys
    if len(argv) != 2 or argv[0] != "verify":
        print("usage: python -m nans_clip_tpu_torch.data.lmdb_store verify "
              "<dir-or-data.mdb>", file=sys.stderr)
        return 2
    try:
        stats = verify(argv[1])
    except LMDBError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(stats))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess test
    import sys
    raise SystemExit(_main(sys.argv[1:]))
