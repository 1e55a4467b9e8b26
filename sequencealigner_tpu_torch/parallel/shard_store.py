# Copy of sequencealigner_tpu/parallel/shard_store.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Sharded multi-host output: per-host ownership of a packed-triangular
pair range, point-to-point triplet routing, per-host HDF5 shards + stitch.

The all-gather merge (multihost.TripletMerger) gives every host the FULL
triplet set — O(P)-redundant network bytes and a full-size store per host,
which is exactly what a 1M-sequence run (a 2 TB packed triangle) cannot
afford.  This module is the config-5 architecture: the packed-triangular
id space (reference reference src/util/macros.h:13 — row j owns ids
[j(j-1)/2, j(j+1)/2)) partitions cleanly by ROW ranges, so

- each host OWNS a contiguous row range [lo, hi) sized to ~equal pair
  counts (RowPartition);
- each host STORES only its own range (ShardStore: tri(hi)-tri(lo)
  entries — 1/P of the triangle);
- at every flush, computed triplets are routed point-to-point to their
  owner (TripletRouter over plain TCP: host-side I/O is runtime-layer
  work, not device compute — no collective ships the union anywhere, and
  no host ever holds or transfers the full set);
- each host writes its own HDF5 shard (write_shard), and stitch_shards
  concatenates them into the single standard output file, row-block by
  row-block (the same /similarity_matrix schema io/hdf5_io.py writes).

Engine integration: pass the router as ``merger=`` and a ShardStore as
``store=`` to Engine.align_all — the router returns only OWNED triplets,
which is precisely what the store accepts.  Scoring stripes (partition=)
and storage ranges are independent axes: striping balances COMPUTE,
row-ranges balance STORAGE; the router is the bridge.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np

from .. import system

_MAGIC = 0x53514C52  # 'SQLR'
_HDR = struct.Struct("<IIQ")  # magic, round, npairs


def tri(n: int) -> int:
    return n * (n - 1) // 2


class RowPartition:
    """Equal-pair-count partition of the packed triangle by row ranges.

    bounds[k] .. bounds[k+1] is host k's row range; row j (owning the j
    pairs (i, j), i < j) belongs to the host whose range contains j.
    Row-aligned ranges make each shard a CONTIGUOUS slice of the packed
    triangle AND a contiguous row block of the square matrix — so shard
    HDF5 writes and stitching are sequential."""

    def __init__(self, dim: int, nhosts: int):
        self.dim = dim
        self.nhosts = nhosts
        total = tri(dim)
        bounds = [0]
        for k in range(1, nhosts):
            target = total * k // nhosts
            # smallest j with tri(j) >= target (j in [0, dim])
            j = int((1 + np.sqrt(1 + 8.0 * target)) // 2)
            while tri(j) < target:
                j += 1
            while j > 0 and tri(j - 1) >= target:
                j -= 1
            bounds.append(min(max(j, bounds[-1]), dim))
        bounds.append(self.dim)
        self.bounds = np.asarray(bounds, np.int64)

    def owner_of(self, j: np.ndarray) -> np.ndarray:
        """Owner host of pairs whose larger index is j."""
        return np.searchsorted(self.bounds[1:-1], j, side="right")

    def rows_of(self, host: int) -> tuple[int, int]:
        return int(self.bounds[host]), int(self.bounds[host + 1])


class ShardStore:
    """Triangular score store for ONE host's row range [lo, hi): flat
    packed-triangle slice of tri(hi) - tri(lo) int32 entries.  API mirrors
    the slice of OutputStore the engine's flush path uses."""

    def __init__(self, dim: int, lo: int, hi: int, *, spill: bool = False):
        assert 0 <= lo <= hi <= dim
        self.dim = dim
        self.lo, self.hi = lo, hi
        self.triangular = True
        self.base = tri(lo)
        self.n_elems = tri(hi) - self.base
        self.matrix = system.alloc_array(max(self.n_elems, 1), np.int32, spill)

    def _index(self, i, j):
        i = np.asarray(i, np.int64)
        j = np.asarray(j, np.int64)
        if len(j) and not ((j >= self.lo) & (j < self.hi)).all():
            raise ValueError("pair outside this shard's row range")
        return j * (j - 1) // 2 + i - self.base

    def fill_pairs(self, i, j, scores) -> None:
        self.matrix[self._index(i, j)] = np.asarray(scores, np.int32)

    def read_pairs(self, i, j) -> np.ndarray:
        return self.matrix[self._index(i, j)]

    def rows(self, a: int, b: int) -> np.ndarray:
        """Square-matrix rows [a, b) of the symmetric similarity matrix,
        RESTRICTED to columns this shard can source (all of them for rows
        within the shard IFF the full lower-left is inside; used by
        write_shard which only asks for the shard's own row block and the
        columns i < j it owns — the symmetric upper part is stitched from
        the OTHER shards' data at stitch time)."""
        raise NotImplementedError("use write_shard/stitch_shards")

    def sync(self) -> None:
        if hasattr(self.matrix, "flush"):
            self.matrix.flush()


class TripletRouter:
    """Point-to-point all-to-all triplet exchange: each flush round, every
    host sends each peer ONLY the triplets that peer owns and receives its
    own.  Plain TCP full mesh (one duplex connection per host pair), a
    background receiver thread per connection (always draining, so
    symmetric sends cannot deadlock), 20 B/pair on the wire.

    Flush rounds must be globally aligned (the engine already counts all
    hosts' blocks toward its flush cadence); a round counter in every
    frame header turns a misalignment into a loud error instead of data
    corruption.
    """

    def __init__(
        self, host_id: int, nhosts: int, partition: RowPartition,
        addrs: list[tuple[str, int]], *, listen_backlog: int = 8,
        connect_timeout: float = 60.0,
    ):
        self.host_id = host_id
        self.nhosts = nhosts
        self.part = partition
        self.round = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self._conns: dict[int, socket.socket] = {}
        self._frames: dict[int, "queue.Queue"] = {}
        self._threads: list[threading.Thread] = []
        if nhosts == 1:
            return
        import queue as _queue

        srv = socket.create_server(
            ("", addrs[host_id][1]), backlog=listen_backlog
        )
        srv.settimeout(connect_timeout)
        # Deterministic full mesh: connect to lower ids, accept higher ids.
        expect = set(range(host_id + 1, nhosts))
        for p in range(host_id):
            deadline = time.monotonic() + connect_timeout
            while True:
                try:
                    s = socket.create_connection(addrs[p], timeout=5.0)
                    break
                except OSError:
                    # Peer's listener may not be up yet (hosts start
                    # concurrently); retry until the shared deadline.
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.2)
            s.sendall(struct.pack("<I", host_id))
            self._conns[p] = s
        while expect:
            s, _ = srv.accept()
            (pid,) = struct.unpack("<I", self._recv_exact(s, 4))
            assert pid in expect, pid
            expect.discard(pid)
            self._conns[pid] = s
        srv.close()
        for p, s in self._conns.items():
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            q = _queue.Queue()
            self._frames[p] = q
            t = threading.Thread(
                target=self._recv_loop, args=(s, q), daemon=True
            )
            t.start()
            self._threads.append(t)

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return bytes(buf)

    def _recv_loop(self, s: socket.socket, q) -> None:
        try:
            while True:
                hdr = self._recv_exact(s, _HDR.size)
                magic, rnd, npairs = _HDR.unpack(hdr)
                if magic != _MAGIC:
                    raise ConnectionError("bad frame magic")
                payload = self._recv_exact(s, npairs * 20)
                q.put((rnd, npairs, payload))
        except (ConnectionError, OSError):
            q.put(None)  # EOF sentinel

    @staticmethod
    def _pack(i, j, s) -> bytes:
        n = len(s)
        buf = np.empty(5 * n, np.int32)
        buf[0 : 2 * n] = np.ascontiguousarray(i, np.int64).view(np.int32)
        buf[2 * n : 4 * n] = np.ascontiguousarray(j, np.int64).view(np.int32)
        buf[4 * n : 5 * n] = np.asarray(s, np.int32)
        return buf.tobytes()

    @staticmethod
    def _unpack(npairs: int, payload: bytes):
        buf = np.frombuffer(payload, np.int32)
        n = npairs
        i = buf[0 : 2 * n].view(np.int64)
        j = buf[2 * n : 4 * n].view(np.int64)
        s = buf[4 * n : 5 * n]
        return i, j, s

    def __call__(self, i, j, s):
        """Route one flush's triplets; returns the OWNED union (this
        host's kept triplets + every peer's contributions)."""
        if self.nhosts == 1:
            return i, j, s
        i = np.asarray(i, np.int64)
        j = np.asarray(j, np.int64)
        s = np.asarray(s, np.int32)
        owner = self.part.owner_of(j)
        keep = owner == self.host_id
        ii, jj, ss = [i[keep]], [j[keep]], [s[keep]]
        rnd = self.round
        self.round += 1
        for p in sorted(self._conns):
            sel = owner == p
            payload = self._pack(i[sel], j[sel], s[sel])
            frame = _HDR.pack(_MAGIC, rnd, int(sel.sum())) + payload
            self._conns[p].sendall(frame)
            self.bytes_sent += len(frame)
        for p in sorted(self._frames):
            got = self._frames[p].get()
            if got is None:
                raise ConnectionError(f"peer {p} closed mid-run")
            prnd, npairs, payload = got
            if prnd != rnd:
                raise RuntimeError(
                    f"flush round misalignment: peer {p} sent round {prnd}, "
                    f"local round {rnd}"
                )
            self.bytes_received += _HDR.size + len(payload)
            pi, pj, ps = self._unpack(npairs, payload)
            ii.append(pi)
            jj.append(pj)
            ss.append(ps)
        return np.concatenate(ii), np.concatenate(jj), np.concatenate(ss)

    def close(self) -> None:
        for s in self._conns.values():
            try:
                s.close()
            except OSError:
                pass


def write_shard(path: str, shard: ShardStore) -> None:
    """One host's HDF5 shard: its packed-triangle slice plus range
    metadata — row-contiguous, no conversion (stitch does the square)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["dim"] = shard.dim
        f.attrs["row_lo"] = shard.lo
        f.attrs["row_hi"] = shard.hi
        f.create_dataset("/tri_slice", data=np.asarray(shard.matrix))


def stitch_shards(
    shard_paths: list[str], out_path: str, seqs, *, compression: int = 0,
    progress: bool = False,
) -> None:
    """Concatenate per-host shards into the standard single output file
    (same /sequences + /similarity_matrix schema as io/hdf5_io.write).
    Row-aligned shards make this a sequential pass: the lower triangle
    comes straight from each shard; the strict upper triangle of row
    block [lo, hi) gathers column slices j > hi-1 from LATER shards —
    each gather is a contiguous per-row slice of a packed triangle row."""
    import h5py

    from ..io.hdf5_io import chunk_dim
    from .. import ui

    metas = []
    for p in shard_paths:
        with h5py.File(p, "r") as f:
            metas.append((int(f.attrs["row_lo"]), int(f.attrs["row_hi"]), p))
    metas.sort()
    dim = None
    with h5py.File(shard_paths[0], "r") as f:
        dim = int(f.attrs["dim"])
    assert metas[0][0] == 0 and metas[-1][1] == dim, "shards must tile rows"

    with h5py.File(out_path, "w", libver="latest") as out:
        import h5py as _h5

        str_dt = _h5.string_dtype(encoding="ascii")
        out.create_dataset(
            "/sequences",
            data=[seqs.get_bytes(k) for k in range(dim)],
            dtype=str_dt,
        )
        cdim = chunk_dim(dim, compression)
        kwargs = {}
        if cdim is not None:
            kwargs["chunks"] = (cdim, cdim)
            if compression:
                kwargs["compression"] = "gzip"
                kwargs["compression_opts"] = compression
        dset = out.create_dataset(
            "/similarity_matrix", shape=(dim, dim), dtype="<i4", **kwargs
        )
        handles = {p: h5py.File(p, "r") for _, _, p in metas}
        try:
            bar = ui.Progress(dim, "Stitching shards") if progress else None
            for lo, hi, p in metas:
                sl = handles[p]["/tri_slice"]
                base = tri(lo)
                # Chunk rows to bound memory.
                step = max(1, (64 << 20) // max(dim * 4, 1))
                for a in range(lo, hi, step):
                    b = min(a + step, hi)
                    block = np.zeros((b - a, dim), np.int32)
                    # Lower triangle rows from this shard (row j: i < j).
                    flat = np.asarray(sl[tri(a) - base : tri(b) - base])
                    off = 0
                    for jrow in range(a, b):
                        block[jrow - a, :jrow] = flat[off : off + jrow]
                        off += jrow
                    # Upper part: entry (j, c) for c > j equals pair
                    # (i=j, larger=c) owned by c's shard.
                    for lo2, hi2, p2 in metas:
                        if hi2 <= a:
                            continue
                        sl2 = handles[p2]["/tri_slice"]
                        base2 = tri(lo2)
                        c0, c1 = max(lo2, a + 1), hi2
                        if c0 >= c1:
                            continue
                        flat2 = np.asarray(
                            sl2[tri(c0) - base2 : tri(c1) - base2]
                        )
                        off2 = 0
                        for c in range(c0, c1):
                            row = flat2[off2 : off2 + c]
                            s0, s1 = max(a, 0), min(b, c)
                            if s0 < s1:
                                block[s0 - a : s1 - a, c] = row[s0:s1]
                            off2 += c
                    dset[a:b] = block
                    if bar:
                        bar.add(b - a)
            if bar:
                bar.end()
        finally:
            for h in handles.values():
                h.close()
