"""FramePack: a memory-mapped container of compressed frames (a copy of
``hmmc_tpu/data/framepack.py``; the file format is the same byte for byte,
so a pack written by either package reads in the other).

One blob file holds every video's frames contiguously, followed by a JSON
index ``{video_id: [offset, [sizes...]]}``:

    [8b magic 'FPACK\\x00\\x01\\x00'][8b index_offset little-endian]
    [frame blobs ...][JSON index][index ends at EOF]

The reader maps the file lazily (fork-safe: each process maps its own). The
first map is made under a lock and keeps its file object for as long as the
map lives: loader threads that read a cold reader at once never see a file
descriptor that another thread has just closed. The reference's LMDB
databases (``LmdbFrameReader`` in the JAX package) are not read here yet:
the card's machine has no ``lmdb`` binding (ROADMAP.md Queue A).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MAGIC = b"FPACK\x00\x01\x00"


class FramePackWriter:
    """Append-only writer. Frames of one video must be added in one
    ``add_video`` call (contiguity guarantee)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<Q", 0))  # index offset patched on close
        self._index: Dict[str, Tuple[int, List[int]]] = {}
        self._meta: Dict[str, object] = {}

    def add_video(self, video_id: str, frames: Sequence[bytes]) -> None:
        if video_id in self._index:
            raise ValueError(f"duplicate video id {video_id!r}")
        offset = self._f.tell()
        sizes = []
        for blob in frames:
            self._f.write(blob)
            sizes.append(len(blob))
        self._index[video_id] = (offset, sizes)

    def set_metadata(self, **kv) -> None:
        self._meta.update(kv)

    def close(self) -> None:
        index_offset = self._f.tell()
        payload = json.dumps(
            {"index": self._index, "meta": self._meta}).encode("utf-8")
        self._f.write(payload)
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack("<Q", index_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FramePackReader:
    """mmap-backed random access, safe to share between threads."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._mm: Optional[mmap.mmap] = None
        self._file = None
        # read the index eagerly (small) without keeping an fd
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise ValueError(f"{path}: not a FramePack file")
            (index_offset,) = struct.unpack("<Q", f.read(8))
            f.seek(index_offset)
            payload = json.loads(f.read().decode("utf-8"))
        self._index: Dict[str, Tuple[int, List[int]]] = {
            k: (v[0], v[1]) for k, v in payload["index"].items()}
        self.metadata: Dict[str, object] = payload.get("meta", {})

    def _map(self) -> mmap.mmap:
        mm = self._mm
        if mm is None:
            with self._lock:
                if self._mm is None:
                    f = open(self.path, "rb")
                    self._mm = mmap.mmap(f.fileno(), 0,
                                         access=mmap.ACCESS_READ)
                    self._file = f
                mm = self._mm
        return mm

    # -- reads ---------------------------------------------------------------

    def video_ids(self) -> Iterable[str]:
        return self._index.keys()

    def num_frames(self, video_id: str) -> int:
        return len(self._index[video_id][1])

    def get_frame(self, video_id: str, frame_idx: int) -> memoryview:
        """Zero-copy view of one frame blob."""
        mm = self._map()
        offset, sizes = self._index[video_id]
        start = offset + sum(sizes[:frame_idx])
        return memoryview(mm)[start:start + sizes[frame_idx]]

    def get_frames(self, video_id: str,
                   indices: Sequence[int]) -> List[memoryview]:
        mm = self._map()
        offset, sizes = self._index[video_id]
        starts = []
        acc = offset
        for s in sizes:
            starts.append(acc)
            acc += s
        mv = memoryview(mm)
        return [mv[starts[i]:starts[i] + sizes[i]] for i in indices]

    def __contains__(self, video_id: str) -> bool:
        return video_id in self._index

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        with self._lock:
            if self._mm is not None:
                self._mm.close()
                self._file.close()
                self._mm = self._file = None


def open_frame_store(path: str) -> FramePackReader:
    """A FramePack reader; anything that is not a FramePack raises."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) == MAGIC:
                return FramePackReader(path)
    raise ValueError(
        f"{path!r} is not a FramePack file; reading the reference's LMDB "
        "frame stores is not ported yet (ROADMAP.md Queue A: the card's "
        "machine has no lmdb binding). Convert it to a FramePack with the "
        "JAX package's tools first.")
