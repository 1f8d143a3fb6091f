"""Video export (port of ``utils/video.py``): ``denorm``, ``convert_seq2gif``,
``write_gif``, ``write_image``, ``save_video`` and the MJPEG AVI writer and
reader it falls back on, and the trainers' ``plot_vid``. Sequences are numpy
arrays (or CPU tensors) in the layout the facade returns, (B, T, C, H, W) in
[-1, 1].

Every writer calls ``imageio`` where it is installed, as the JAX package
does, and writes with PIL alone where it is not: a GIF through PIL's GIF
writer, an image in the format its suffix names, a video as an MJPEG AVI.
``imageio`` and PIL are imported only where a file is written or read."""

from __future__ import annotations

import os

import numpy as np


def denorm(x):
    return np.clip((np.asarray(x) + 1.0) / 2.0, 0.0, 1.0)


def convert_seq2gif(sequence) -> np.ndarray:
    """(B,T,C,H,W) in [-1,1] → (T,H,B*W,3) uint8-ranged float frames, batch
    tiled horizontally (reference lines 15-22)."""
    seq = denorm(sequence)
    seq = np.transpose(seq, (0, 1, 3, 4, 2))  # (B,T,H,W,C)
    img_gif = np.concatenate(list(seq), axis=2)  # tile batch along width
    maxv = np.max(img_gif)
    if maxv > 0:
        img_gif = 255.0 * img_gif / maxv
    return img_gif


def write_gif(path: str, frames, fps: int = 3) -> None:
    """(T, H, W, 3) frames as a looping GIF at ``fps``, as uint8:
    ``imageio.mimsave`` where imageio is installed, else PIL's GIF writer (a
    machine with PIL alone)."""
    frames = np.asarray(frames).astype(np.uint8)
    try:
        import imageio
    except ImportError:
        from PIL import Image

        images = [Image.fromarray(f) for f in frames]
        images[0].save(path, save_all=True, append_images=images[1:],
                       duration=round(1000 / fps), loop=0)
        return
    imageio.mimsave(path, frames, fps=fps)


def write_image(path: str, image) -> None:
    """One (H, W, 3) image as uint8: ``imageio.imwrite`` where imageio is
    installed, else PIL, in the format the suffix names (``.png``, ``.jpg``)."""
    image = np.asarray(image).astype(np.uint8)
    try:
        import imageio
    except ImportError:
        from PIL import Image

        Image.fromarray(image).save(path)
        return
    imageio.imwrite(path, image)


def save_video(path: str, video: np.ndarray, fps: int = 3, loops: int = 6) -> None:
    """Looped video export (reference ``utils/auxiliaries.py:25-30`` writes a
    6x-looped mp4 next to every GIF). mp4 needs an ffmpeg imageio backend;
    without one we still always produce a real video artifact by writing a
    pure-Python MJPEG AVI next to the requested path (every mainstream player
    decodes MJPEG; no external codec binary involved), also where imageio
    itself is missing."""
    long_video = np.tile(video, (loops, 1, 1, 1)).astype(np.uint8)
    try:
        import imageio

        writer = imageio.get_writer(path, fps=fps)
    except (ValueError, ImportError):
        write_mjpeg_avi(os.path.splitext(path)[0] + ".avi", long_video, fps=fps)
        return
    for im in long_video:
        writer.append_data(im)
    writer.close()


def plot_vid(opt, sequences, epoch: int = 0, mode: str = "train", path: str | None = None,
             axis: int = 1) -> np.ndarray:
    """Tile generated and real clips (two (B, T, C, H, W) arrays in [-1, 1])
    next to each other, crop to a multiple of 16 px, write a GIF and a
    looped video under ``<save_path>/videos/`` (or ``path``), and return the
    frames as (T, C, H, W) uint8."""
    sequence_gen, sequence_orig = sequences
    seq = np.concatenate((convert_seq2gif(sequence_gen), convert_seq2gif(sequence_orig)),
                         axis=axis)
    x, y = seq.shape[1] // 16 * 16, seq.shape[2] // 16 * 16
    seq = seq[:, :x, :y]
    if path is None:
        base = os.path.join(opt.Training["save_path"], "videos", f"{epoch + 1:03d}_sequence_{mode}")
    else:
        base = path + "seq"
    write_gif(base + ".gif", seq, fps=3)
    save_video(base + ".mp4", seq)
    return seq.astype(np.uint8).transpose(0, 3, 1, 2)


def write_mjpeg_avi(
    path: str, frames: np.ndarray, fps: int = 3, quality: int = 92
) -> None:
    """Write (T, H, W, 3) uint8 frames as an MJPEG AVI without ffmpeg.

    Plain RIFF container: one ``00dc`` chunk per JPEG-encoded frame (PIL)
    plus the ``idx1`` index. MJPEG has no inter-frame state, so the writer
    is ~container bookkeeping only.
    """
    import io
    import struct

    from PIL import Image

    frames = np.asarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T,H,W,3) uint8 frames, got {frames.shape}")
    if frames.shape[0] == 0:
        raise ValueError("write_mjpeg_avi needs at least one frame")
    n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]

    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    max_jpeg = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        # RIFF: ckSize is the UNPADDED payload length; a pad byte follows
        # odd-length payloads to keep chunks word-aligned.
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        int(1_000_000 // fps),  # dwMicroSecPerFrame
        max_jpeg * fps,  # dwMaxBytesPerSec
        0,  # dwPaddingGranularity
        0x10,  # dwFlags: AVIF_HASINDEX
        n, 0, 1,  # dwTotalFrames, dwInitialFrames, dwStreams
        max_jpeg, w, h, 0, 0, 0, 0,
    )
    strh = (
        b"vidsMJPG"
        + struct.pack(
            "<10I4H",
            0, 0, 0,  # dwFlags, wPriority|wLanguage, dwInitialFrames
            1, fps,  # dwScale, dwRate → fps frames/s
            0, n,  # dwStart, dwLength (frames)
            max_jpeg, 0xFFFFFFFF, 0,  # buffer, quality(-1), sample size
            0, 0, w, h,  # rcFrame
        )
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"".join(chunk(b"00dc", j) for j in jpegs)
    idx, off = [], 4  # chunk offsets are relative to the 'movi' fourcc
    for j in jpegs:
        idx.append(b"00dc" + struct.pack("<3I", 0x10, off, len(j)))
        off += 8 + len(j) + (len(j) % 2)  # header + payload + pad byte
    idx1 = chunk(b"idx1", b"".join(idx))

    riff = b"AVI " + hdrl + lst(b"movi", movi_payload) + idx1
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


def read_mjpeg_avi(path: str) -> np.ndarray:
    """Decode an AVI written by :func:`write_mjpeg_avi` back to (T,H,W,3)
    uint8 (test round-trips; also a no-ffmpeg reader for spot checks)."""
    import io
    import struct

    from PIL import Image

    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"AVI ":
        raise ValueError(f"{path} is not a RIFF AVI file")

    # Walk top-level chunks structurally until the 'movi' LIST, then iterate
    # its sub-chunks — no pattern search, so header bytes can't alias '00dc'.
    def _find_movi(pos: int, end: int) -> tuple[int, int]:
        while pos + 8 <= end:
            fourcc = blob[pos : pos + 4]
            size = struct.unpack("<I", blob[pos + 4 : pos + 8])[0]
            if fourcc == b"LIST" and blob[pos + 8 : pos + 12] == b"movi":
                return pos + 12, pos + 8 + size
            pos += 8 + size + (size % 2)
        raise ValueError(f"{path}: no 'movi' LIST found")

    pos, end = _find_movi(12, 8 + struct.unpack("<I", blob[4:8])[0])
    frames = []
    while pos + 8 <= end:
        fourcc = blob[pos : pos + 4]
        size = struct.unpack("<I", blob[pos + 4 : pos + 8])[0]
        if fourcc == b"00dc":
            payload = blob[pos + 8 : pos + 8 + size]
            frames.append(np.asarray(Image.open(io.BytesIO(payload)).convert("RGB")))
        pos += 8 + size + (size % 2)
    return np.stack(frames)
