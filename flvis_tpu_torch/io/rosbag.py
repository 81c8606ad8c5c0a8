"""Copy of flvis_tpu/io/rosbag.py (the port keeps its own; it imports nothing of flvis_tpu).

Minimal ROS1 rosbag v2.0 reader — no ROS required.

Replaces the reference's `rosbag play` ingestion for the D435i modes
(the reference: README.md:43-126: `rosbag play melab_sn943222072828.bag`,
topics like /camera/infra1/image_rect_raw, /camera/aligned_depth_to_color/
image_raw, /camera/imu) with a pure-Python parser for the documented bag
container format: framed records (header-len, header fields, data-len,
data), connection records carrying topic/type, chunk records (none or bz2
compression) containing message-data records, and hand-rolled
deserializers for sensor_msgs/Image and sensor_msgs/Imu.

Only the subset FLVIS needs is implemented; unindexed reading (sequential
chunk scan) keeps it simple and streaming-friendly.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Iterator, Optional

import numpy as np

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _read_record(f):
    lenbuf = f.read(4)
    if len(lenbuf) < 4:
        return None, None
    (hlen,) = struct.unpack("<I", lenbuf)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data = f.read(dlen)
    return header, data


def _records_in(buf: bytes):
    off = 0
    while off < len(buf):
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return v if n > 1 else v[0]

    def string(self):
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def bytes_(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


def _parse_time(c: _Cursor) -> float:
    return c.u32() + 1e-9 * c.u32()


@dataclasses.dataclass
class ImageMsg:
    t: float
    height: int
    width: int
    encoding: str
    data: np.ndarray  # (H, W) float32 — gray intensity or raw depth units


@dataclasses.dataclass
class ImuMsg:
    t: float
    gyro: np.ndarray  # (3,)
    acc: np.ndarray   # (3,)


def _decode_image(data: bytes) -> ImageMsg:
    c = _Cursor(data)
    c.u32()                       # header.seq
    t = _parse_time(c)
    c.string()                    # frame_id
    h = c.u32()
    w = c.u32()
    enc = c.string()
    c.u8()                        # is_bigendian
    step = c.u32()
    n = c.u32()
    raw = c.bytes_(n)
    if enc in ("mono8", "8UC1"):
        img = np.frombuffer(raw, np.uint8).reshape(h, step)[:, :w].astype(np.float32)
    elif enc in ("mono16", "16UC1"):
        img = np.frombuffer(raw, np.uint16).reshape(h, step // 2)[:, :w].astype(np.float32)
    elif enc in ("rgb8", "bgr8"):
        px = np.frombuffer(raw, np.uint8).reshape(h, step)[:, : w * 3].reshape(h, w, 3)
        img = px.mean(axis=-1).astype(np.float32)
    else:
        raise ValueError(f"unsupported image encoding {enc!r}")
    return ImageMsg(t=t, height=h, width=w, encoding=enc, data=img)


def _decode_imu(data: bytes) -> ImuMsg:
    c = _Cursor(data)
    c.u32()
    t = _parse_time(c)
    c.string()
    c.f64(4)                      # orientation quaternion (unused)
    c.f64(9)                      # orientation covariance
    gyro = np.asarray(c.f64(3))
    c.f64(9)
    acc = np.asarray(c.f64(3))
    return ImuMsg(t=t, gyro=gyro, acc=acc)


class BagReader:
    """Sequential reader yielding (topic, msg) for selected topics."""

    DECODERS = {
        "sensor_msgs/Image": _decode_image,
        "sensor_msgs/Imu": _decode_imu,
    }

    def __init__(self, path: str, topics: Optional[list] = None):
        self.path = path
        self.topics = set(topics) if topics else None

    def messages(self) -> Iterator[tuple]:
        connections: dict[int, tuple[str, str]] = {}  # conn id → (topic, type)
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a rosbag v2.0 file: {self.path}")
            while True:
                header, data = _read_record(f)
                if header is None:
                    return
                op = header.get("op", b"\x00")[0]
                if op == _OP_CONNECTION:
                    conn = int.from_bytes(header["conn"], "little")
                    topic = header["topic"].decode()
                    info = _parse_header(data)
                    mtype = info.get("type", b"").decode()
                    connections[conn] = (topic, mtype)
                elif op == _OP_CHUNK:
                    comp = header.get("compression", b"none").decode()
                    if comp == "none":
                        chunk = data
                    elif comp == "bz2":
                        chunk = bz2.decompress(data)
                    else:
                        raise ValueError(f"unsupported chunk compression {comp!r}")
                    for h2, d2 in _records_in(chunk):
                        op2 = h2.get("op", b"\x00")[0]
                        if op2 == _OP_CONNECTION:
                            conn = int.from_bytes(h2["conn"], "little")
                            info = _parse_header(d2)
                            connections[conn] = (
                                h2["topic"].decode(), info.get("type", b"").decode())
                        elif op2 == _OP_MSG:
                            yield from self._emit(h2, d2, connections)
                elif op == _OP_MSG:
                    yield from self._emit(header, data, connections)
                # bag header / index / chunk-info records are skipped.

    def _emit(self, header, data, connections):
        conn = int.from_bytes(header["conn"], "little")
        topic, mtype = connections.get(conn, (None, None))
        if topic is None:
            return
        if self.topics is not None and topic not in self.topics:
            return
        dec = self.DECODERS.get(mtype)
        if dec is None:
            return
        yield topic, dec(data)


@dataclasses.dataclass
class D435iFrame:
    t: float
    img0: np.ndarray          # infra1 gray (or gray from color)
    img1: np.ndarray          # infra2 gray (stereo) or depth image (depth mode)
    imu_t: np.ndarray
    imu_acc: np.ndarray
    imu_gyro: np.ndarray


def d435i_frames(path: str, img0_topic: str, img1_topic: str,
                 imu_topic: str = "/camera/imu",
                 remap_imu_to_enu: bool = True,
                 skip_first: int = 0) -> Iterator[D435iFrame]:
    """Pair synchronized image topics + group IMU per frame, with the D435i
    body-axis → ENU remap the reference applies in its IMU callback
    (vo_tracking.cpp:331-357: for D435i, acc/gyro (x,y,z) → (z, -x, -y))."""
    skipped = 0
    pending0: dict[float, ImageMsg] = {}
    pending1: dict[float, ImageMsg] = {}
    imu_buf: list[ImuMsg] = []
    last_emit_t = -np.inf
    t_origin = None
    PAIR_TOL = 2e-3   # stereo/depth stamps within 2 ms pair up
    STALE = 1.0       # unmatched frames older than 1 s are dropped

    for topic, msg in BagReader(path, [img0_topic, img1_topic, imu_topic]).messages():
        # Rebase to the first message's time: epoch floats lose all
        # sub-second resolution in float32 downstream.
        if t_origin is None:
            t_origin = msg.t
        msg.t -= t_origin
        if topic == imu_topic:
            imu_buf.append(msg)
            continue
        side = pending0 if topic == img0_topic else pending1
        other = pending1 if topic == img0_topic else pending0
        # Nearest-stamp pairing with tolerance (fixed rounding buckets drop
        # boundary-straddling pairs), plus stale-entry pruning so dropped
        # frames on one topic can't leak decoded images indefinitely.
        for stale_k in [kk for kk in side if msg.t - kk > STALE]:
            side.pop(stale_k)
        for stale_k in [kk for kk in other if msg.t - kk > STALE]:
            other.pop(stale_k)
        k = None
        if other:
            cand = min(other, key=lambda kk: abs(kk - msg.t))
            if abs(cand - msg.t) <= PAIR_TOL:
                k = cand
        if k is not None:
            m_other = other.pop(k)
            m0, m1 = (msg, m_other) if topic == img0_topic else (m_other, msg)
            if skipped < skip_first:
                # Warmup decimation (the reference's skip_first_n_imgs,
                # f2f_tracking.cpp:120-140); IMU keeps flowing.
                skipped += 1
                last_emit_t = m0.t
                continue
            sel = [m for m in imu_buf if last_emit_t < m.t <= m0.t]
            imu_buf = [m for m in imu_buf if m.t > m0.t]
            acc = np.asarray([m.acc for m in sel], np.float32).reshape(-1, 3)
            gyro = np.asarray([m.gyro for m in sel], np.float32).reshape(-1, 3)
            if remap_imu_to_enu and len(sel):
                acc = np.stack([acc[:, 2], -acc[:, 0], -acc[:, 1]], axis=1)
                gyro = np.stack([gyro[:, 2], -gyro[:, 0], -gyro[:, 1]], axis=1)
            yield D435iFrame(
                t=m0.t, img0=m0.data, img1=m1.data,
                imu_t=np.asarray([m.t for m in sel], np.float32),
                imu_acc=acc, imu_gyro=gyro,
            )
            last_emit_t = m0.t
        else:
            side[msg.t] = msg
