"""MRAW container reading: lazy, memory-mapped access to packed frame payloads.

A ``.mraw`` file is the raw pixel payload of a Photron recording: frames
concatenated back-to-back, row-major, with no per-frame headers. The pixel
encoding is given by the companion CIH/CIHX header:

* 8-bit  — one byte per pixel.
* 10-bit — MSB-first packed, 4 pixels per 5 bytes.
* 12-bit — MSB-first packed, 2 pixels per 3 bytes:
           ``p0 = (b0 << 4) | (b1 >> 4)``, ``p1 = ((b1 & 0xF) << 8) | b2``.
* 16-bit — little-endian uint16.

Design: the reader memory-maps the byte payload and decodes on access, so a
100 GB recording costs nothing to "open" (parity with the reference's
pyMRAW memmap path, ``src/photron/video.py:332,580``). Two access styles:

* :meth:`MRAWReader.read_frame` / :meth:`read_frames` — decoded ``uint16``
  host arrays (numpy decode, or the C++ native decoder when built).
* :meth:`MRAWReader.frame_bytes` — the *packed* bytes of a frame range, for
  shipping raw (undecoded) data to device memory where a kernel unpacks it
  (:mod:`hsip_tpu.kernels.unpack`); 12-bit packing ships 1.5 bytes/px
  instead of 2.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

__all__ = [
    "MRAWReader",
    "unpack_12bit",
    "pack_12bit",
    "unpack_10bit",
    "pack_10bit",
    "find_mraw_payload",
    "frame_nbytes",
]

PathLike = Union[str, Path]


def frame_nbytes(width: int, height: int, bit_depth: int) -> int:
    """Packed byte size of one frame."""
    npix = width * height
    if bit_depth == 8:
        return npix
    if bit_depth == 10:
        if npix % 4:
            raise ValueError("10-bit packing requires a multiple-of-4 pixel count")
        return npix * 5 // 4
    if bit_depth == 12:
        if npix % 2:
            raise ValueError("12-bit packing requires an even pixel count per frame")
        return npix * 3 // 2
    if bit_depth == 16:
        return npix * 2
    raise ValueError(f"Unsupported bit depth: {bit_depth}")


def unpack_12bit(packed: np.ndarray) -> np.ndarray:
    """Decode MSB-first 12-bit packed bytes to uint16 (host/numpy path).

    ``packed`` is a uint8 array whose length is a multiple of 3; every 3 bytes
    yield 2 pixels. This is the reference decoder the Pallas kernel and the
    C++ decoder are validated against.
    """
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.size % 3:
        raise ValueError("12-bit packed buffer length must be a multiple of 3")
    b = packed.reshape(-1, 3).astype(np.uint16)
    out = np.empty((b.shape[0], 2), dtype=np.uint16)
    out[:, 0] = (b[:, 0] << 4) | (b[:, 1] >> 4)
    out[:, 1] = ((b[:, 1] & 0x0F) << 8) | b[:, 2]
    return out.reshape(-1)


def pack_12bit(pixels: np.ndarray) -> np.ndarray:
    """Encode uint16 pixels (values < 4096) into MSB-first 12-bit bytes."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint16).reshape(-1)
    if pixels.size % 2:
        raise ValueError("12-bit packing requires an even pixel count")
    if pixels.size and int(pixels.max()) > 0xFFF:
        raise ValueError("12-bit packing requires pixel values < 4096")
    p = pixels.reshape(-1, 2)
    out = np.empty((p.shape[0], 3), dtype=np.uint8)
    out[:, 0] = (p[:, 0] >> 4).astype(np.uint8)
    out[:, 1] = (((p[:, 0] & 0x0F) << 4) | (p[:, 1] >> 8)).astype(np.uint8)
    out[:, 2] = (p[:, 1] & 0xFF).astype(np.uint8)
    return out.reshape(-1)


def unpack_10bit(packed: np.ndarray) -> np.ndarray:
    """Decode MSB-first 10-bit packed bytes to uint16 (5 bytes → 4 px)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.size % 5:
        raise ValueError("10-bit packed buffer length must be a multiple of 5")
    b = packed.reshape(-1, 5).astype(np.uint16)
    out = np.empty((b.shape[0], 4), dtype=np.uint16)
    out[:, 0] = (b[:, 0] << 2) | (b[:, 1] >> 6)
    out[:, 1] = ((b[:, 1] & 0x3F) << 4) | (b[:, 2] >> 4)
    out[:, 2] = ((b[:, 2] & 0x0F) << 6) | (b[:, 3] >> 2)
    out[:, 3] = ((b[:, 3] & 0x03) << 8) | b[:, 4]
    return out.reshape(-1)


def pack_10bit(pixels: np.ndarray) -> np.ndarray:
    """Encode uint16 pixels (values < 1024) into MSB-first 10-bit bytes."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint16).reshape(-1)
    if pixels.size % 4:
        raise ValueError("10-bit packing requires a multiple-of-4 pixel count")
    if pixels.size and int(pixels.max()) > 0x3FF:
        raise ValueError("10-bit packing requires pixel values < 1024")
    p = pixels.reshape(-1, 4)
    out = np.empty((p.shape[0], 5), dtype=np.uint8)
    out[:, 0] = (p[:, 0] >> 2).astype(np.uint8)
    out[:, 1] = (((p[:, 0] & 0x03) << 6) | (p[:, 1] >> 4)).astype(np.uint8)
    out[:, 2] = (((p[:, 1] & 0x0F) << 4) | (p[:, 2] >> 6)).astype(np.uint8)
    out[:, 3] = (((p[:, 2] & 0x3F) << 2) | (p[:, 3] >> 8)).astype(np.uint8)
    out[:, 4] = (p[:, 3] & 0xFF).astype(np.uint8)
    return out.reshape(-1)


def find_mraw_payload(metadata_path: PathLike) -> Path:
    """Locate the .mraw payload companion of a .cih/.cihx metadata file.

    Convention: same stem, ``.mraw`` (any case) suffix, same directory.
    """
    meta = Path(metadata_path)
    # Fast path for the overwhelmingly common spellings, then a directory
    # scan so ANY casing (.mRAW, .MRaw, ...) honors the documented contract
    # on case-sensitive filesystems.
    for suffix in (".mraw", ".MRAW", ".Mraw"):
        candidate = meta.with_suffix(suffix)
        if candidate.is_file():
            return candidate
    try:
        for candidate in meta.parent.iterdir():
            # is_file() guards against a DIRECTORY named '<stem>.mraw',
            # which would otherwise surface later as a confusing open error.
            if (candidate.stem == meta.stem
                    and candidate.suffix.lower() == ".mraw"
                    and candidate.is_file()):
                return candidate
    except OSError:
        pass
    raise FileNotFoundError(
        f"No .mraw payload found next to {metadata_path} "
        f"(expected {meta.with_suffix('.mraw')})"
    )


class MRAWReader:
    """Lazy reader over a packed MRAW payload.

    Parameters
    ----------
    path : path to the ``.mraw`` file.
    width, height : frame geometry in pixels.
    bit_depth : 8, 10, 12 or 16.
    total_frames : frame count; inferred from file size when omitted.
    use_native : prefer the C++ codec (packed unpack, fused count pass,
        band row gather) when available.
    """

    def __init__(
        self,
        path: PathLike,
        width: int,
        height: int,
        bit_depth: int,
        total_frames: Optional[int] = None,
        use_native: bool = True,
    ):
        self.path = Path(path)
        self.width = int(width)
        self.height = int(height)
        self.bit_depth = int(bit_depth)
        self._frame_nbytes = frame_nbytes(self.width, self.height, self.bit_depth)

        file_size = self.path.stat().st_size
        max_frames = file_size // self._frame_nbytes
        if total_frames is None:
            total_frames = max_frames
        elif total_frames > max_frames:
            raise ValueError(
                f"Header claims {total_frames} frames but {self.path} holds "
                f"only {max_frames} ({file_size} bytes / {self._frame_nbytes} per frame)"
            )
        self._total_frames = int(total_frames)

        # Memory-map the packed payload; frames page in on access only.
        self._mmap: Optional[np.memmap] = np.memmap(
            self.path, dtype=np.uint8, mode="r",
            shape=(self._total_frames, self._frame_nbytes),
        )

        self._native = None
        if use_native and self.bit_depth in (8, 10, 12, 16):
            try:
                from hsip_tpu._native import native_decoder

                self._native = native_decoder()
            except Exception:  # pragma: no cover - native build unavailable
                self._native = None

    # -- core accessors ----------------------------------------------------

    def __len__(self) -> int:
        return self._total_frames

    @property
    def frame_shape(self) -> tuple:
        return (self.height, self.width)

    @property
    def frame_nbytes(self) -> int:
        """Packed bytes per frame."""
        return self._frame_nbytes

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if self.bit_depth == 8 else np.uint16)

    def _check_open(self) -> None:
        if self._mmap is None:
            raise ValueError("MRAWReader is closed")

    def frame_bytes(self, start: int, stop: Optional[int] = None) -> np.ndarray:
        """Packed bytes for frames [start, stop) as a (n, frame_nbytes) view.

        This is the zero-copy staging path for on-device decode: the returned
        memmap view is handed straight to ``jax.device_put`` so only raw
        packed bytes cross PCIe.
        """
        self._check_open()
        if stop is None:
            stop = start + 1
        return self._mmap[start:stop]

    @property
    def row_nbytes(self) -> Optional[int]:
        """Packed bytes per image ROW, when rows are byte-aligned
        (always for 8/16-bit; 12-bit needs even width; 10-bit width % 4)."""
        bits = self.width * self.bit_depth
        if bits % 8:
            return None
        return bits // 8

    def band_bytes(self, start: int, stop: int, rows: np.ndarray,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Packed bytes of selected ROWS for frames [start, stop).

        Returns (n, len(rows), row_nbytes) uint8 — the minimal staging
        payload when downstream only needs a centerline band (the on-device
        kernels decode just these rows). Requires byte-aligned rows.
        ``out`` (optional, exactly that shape) gathers straight into a
        caller-provided buffer — e.g. one video's slice of a whole-library
        staging array — skipping a copy on the bandwidth-starved host.
        """
        self._check_open()
        rnb = self.row_nbytes
        if rnb is None:
            raise ValueError(
                f"rows are not byte-aligned for width={self.width}, "
                f"bit_depth={self.bit_depth}"
            )
        rows = np.asarray(rows, dtype=np.int64)
        # Validate up front so the native and numpy paths behave identically
        # (numpy fancy indexing would silently wrap negatives; the reshape
        # below would raise confusingly on a stop past EOF).
        if rows.size and (rows.min() < 0 or rows.max() >= self.height):
            raise ValueError(
                f"row indices out of range [0, {self.height}): {rows}"
            )
        stop = min(stop, self._total_frames)
        if self._native is not None:
            # Parallel C++ gather (OpenMP memcpy per row) — bandwidth-bound,
            # but unlike numpy's single-threaded gather it holds its rate
            # when transfer/render threads contend for cores.
            return self._native.gather_rows(
                self._mmap[start:stop], self._frame_nbytes, rows * rnb, rnb,
                out=out,
            )
        view = self._mmap[start:stop].reshape(stop - start, self.height, rnb)
        if out is not None:
            np.copyto(out, view[:, rows, :])
            return out
        return view[:, rows, :]

    def band_bytes_and_counts(
        self,
        start: int,
        stop: int,
        rows: np.ndarray,
        background: float,
        threshold: float,
        out: Optional[np.ndarray] = None,
    ):
        """Fused staging pass: :meth:`band_bytes` + :meth:`count_above` in
        ONE sweep over the packed payload (the native codec's
        ``gather_count*``), so host DRAM traffic for staging is paid once.

        Returns ``(band, counts)`` — identical values to the separate
        calls — or ``None`` when the fused native pass is unavailable
        (no native codec, unsupported depth, or a stale cached ``.so``);
        callers then fall back to the two-pass staging.
        """
        if (
            self._native is None
            or self.bit_depth not in (8, 10, 12, 16)
            or not self._native.has_gather_count
        ):
            return None
        self._check_open()
        rnb = self.row_nbytes
        if rnb is None:
            return None
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size and (rows.min() < 0 or rows.max() >= self.height):
            raise ValueError(
                f"row indices out of range [0, {self.height}): {rows}"
            )
        stop = min(stop, self._total_frames)
        return self._native.gather_rows_count(
            self._mmap[start:stop], self._frame_nbytes, rows * rnb, rnb,
            background, threshold, self.bit_depth, out=out,
        )

    def count_above(
        self, start: int, stop: int, background: float, threshold: float
    ) -> Optional[np.ndarray]:
        """Per-frame above-noise pixel counts straight from packed bytes
        (native 8/10/12/16-bit fast paths; None when unavailable)."""
        if self._native is None or self.bit_depth not in (8, 10, 12, 16):
            return None
        if self.bit_depth == 8 and not self._native.has_count8:
            return None  # stale cached .so without the 8-bit symbol
        self._check_open()
        counter = {
            8: self._native.count_above_8bit,
            10: self._native.count_above_10bit,
            12: self._native.count_above_12bit,
            16: self._native.count_above_16bit,
        }[self.bit_depth]
        return counter(
            self._mmap[start:stop], self._frame_nbytes, background, threshold
        )

    def _decode(self, packed: np.ndarray) -> np.ndarray:
        """Decode packed frame bytes (n, frame_nbytes) -> (n, H, W) pixels."""
        n = packed.shape[0]
        if self.bit_depth == 8:
            return np.array(packed).reshape(n, self.height, self.width)
        if self.bit_depth == 16:
            flat = np.ascontiguousarray(packed).view("<u2")
            return flat.reshape(n, self.height, self.width).copy()
        flat = np.ascontiguousarray(packed).reshape(-1)
        if self.bit_depth == 10:
            out = (
                self._native.unpack_10bit(flat)
                if self._native is not None
                else unpack_10bit(flat)
            )
        else:  # 12-bit
            out = (
                self._native.unpack_12bit(flat)
                if self._native is not None
                else unpack_12bit(flat)
            )
        return out.reshape(n, self.height, self.width)

    def read_frame(self, index: int) -> np.ndarray:
        """Decode one frame to a (H, W) array the caller owns."""
        self._check_open()
        if index < 0:
            index = self._total_frames + index
        if not 0 <= index < self._total_frames:
            raise IndexError(
                f"Frame index {index} out of range [0, {self._total_frames})"
            )
        return self._decode(self._mmap[index : index + 1])[0]

    def read_frames(self, key: slice) -> np.ndarray:
        """Decode a slice of frames to an (n, H, W) array."""
        self._check_open()
        indices = range(*key.indices(self._total_frames))
        step = key.step or 1
        if step == 1 and len(indices) > 0:
            return self._decode(self._mmap[indices.start : indices.stop])
        if len(indices) == 0:
            return np.empty((0, self.height, self.width), dtype=self.dtype)
        return np.stack([self.read_frame(i) for i in indices])

    def close(self) -> None:
        """Release the memory map."""
        self._mmap = None

    def __enter__(self) -> "MRAWReader":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def __repr__(self) -> str:
        return (
            f"<MRAWReader '{self.path.name}' frames={self._total_frames} "
            f"shape=({self.height}, {self.width}) bit_depth={self.bit_depth}>"
        )
