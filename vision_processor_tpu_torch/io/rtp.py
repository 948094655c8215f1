"""RTP debug video streamer with latest-frame-only semantics (PyTorch port).

Copy of vision_processor_tpu/io/rtp.py for the port. The reference streams
H.264 over RTP via ffmpeg with a dedicated encoder thread fed by a one-slot
queue so encoding never stalls the pipeline (reference
src/rtpstreamer.cpp:29-198). Encoder auto-pick, mirroring the reference's
nvenc -> qsv -> vaapi -> libx264 cascade:

1. the native in-process H.264 encoder (io/native.py, built from the
   repository's native/ sources) packetized per RFC 6184 (single-NAL +
   FU-A),
2. an external ffmpeg binary with libx264 when one exists,
3. RTP/JPEG (RFC 2435) with cv2's JPEG encoder as the last resort.

All paths are wire-standard and playable by ffplay/GStreamer/VLC. One
difference from the JAX package: an inactive streamer picks no codec
(``codec`` None), so a process with the stream off builds no encoder.
"""
from __future__ import annotations

import os
import shutil
import socket
import struct
import subprocess
import threading
import time

import numpy as np

from ..utils.log import get_logger

log = get_logger(__name__)

RTP_JPEG_PT = 26  # static payload type for JPEG (RFC 3551)
RTP_H264_PT = 96  # dynamic payload type for H.264 (RFC 6184)
MTU_PAYLOAD = 1400


def split_annexb(stream: bytes):
    """Yield NAL units (without start codes) from an annex-B byte stream."""
    i = 0
    n = len(stream)
    starts = []
    while i < n - 3:
        if stream[i] == 0 and stream[i + 1] == 0:
            if stream[i + 2] == 1:
                starts.append((i, i + 3))
                i += 3
                continue
            if i < n - 4 and stream[i + 2] == 0 and stream[i + 3] == 1:
                starts.append((i, i + 4))
                i += 4
                continue
        i += 1
    for k, (begin, payload) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else n
        yield stream[payload:end]


def packetize_h264(access_unit: bytes, seq: int, ts: int, ssrc: int):
    """RFC 6184 packets for one access unit; yields (packet, next_seq)."""
    nals = list(split_annexb(access_unit))
    for j, nal in enumerate(nals):
        last_nal = j == len(nals) - 1

        if len(nal) <= MTU_PAYLOAD:
            header = struct.pack(
                "!BBHII", 0x80, RTP_H264_PT | (0x80 if last_nal else 0),
                seq & 0xFFFF, ts, ssrc,
            )
            yield header + nal
            seq += 1
            continue
        # FU-A fragmentation
        indicator = (nal[0] & 0x60) | 28
        nal_type = nal[0] & 0x1F
        body = nal[1:]
        off = 0
        while off < len(body):
            chunk = body[off:off + MTU_PAYLOAD - 2]
            first = off == 0
            off += len(chunk)
            final = off >= len(body)
            fu_header = (0x80 if first else 0) | (0x40 if final else 0) | nal_type
            pkt = struct.pack(
                "!BBHII", 0x80,
                RTP_H264_PT | (0x80 if (last_nal and final) else 0),
                seq & 0xFFFF, ts, ssrc,
            ) + bytes([indicator, fu_header]) + chunk
            yield pkt
            seq += 1


def depacketize_h264(packets) -> bytes:
    """Reassemble annex-B from RFC 6184 packets (test/monitor helper)."""
    out = bytearray()
    fu = bytearray()
    for pkt in packets:
        payload = pkt[12:]
        if not payload:
            continue
        nal_type = payload[0] & 0x1F
        if nal_type == 28:  # FU-A
            fu_header = payload[1]
            if fu_header & 0x80:  # start
                fu = bytearray(
                    [(payload[0] & 0x60) | (fu_header & 0x1F)]
                )
            fu.extend(payload[2:])
            if fu_header & 0x40:  # end
                out += b"\x00\x00\x00\x01" + fu
                fu = bytearray()
        else:
            out += b"\x00\x00\x00\x01" + payload
    return bytes(out)


class _LatestSlot:
    """One-slot queue: writers overwrite, the reader drains the newest."""

    def __init__(self):
        self._value = None
        self._cond = threading.Condition()
        self._closed = False

    def offer(self, value) -> None:
        with self._cond:
            self._value = value
            self._cond.notify()

    def take(self, timeout=0.5):
        with self._cond:
            if self._value is None:
                self._cond.wait(timeout)
            value, self._value = self._value, None
            return value

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify()


def _parse_rtp_url(url: str) -> tuple[str, int]:
    rest = url.split("://", 1)[1]
    host, port = rest.rsplit(":", 1)
    return host, int(port)


class RTPStreamer:
    """Encoder thread + RTP packetizer, ~30 fps pacing, latest frame only."""

    def __init__(self, active: bool, url: str, framerate: float = 30.0,
                 codec: str | None = None, qp: int = 24,
                 bitrate_kbps: float = 0, gop: int = 0):
        self.active = active
        self.url = url
        self.framerate = framerate
        # qp 10-29 selects the compressed CAVLC intra tier (the LAN debug
        # default, <50 Mb/s at 1080p30 on camera content); qp 0 selects
        # lossless I_PCM (~750 Mb/s at 1080p30 — capture only)
        self.qp = int(qp) if qp else None
        # target bitrate (frame-level QP rate control); VPTPU_KBPS
        # overrides, 0 = fixed QP
        env_kbps = os.environ.get("VPTPU_KBPS", "")
        try:
            self.bitrate_kbps = float(env_kbps) if env_kbps \
                else float(bitrate_kbps or 0)
        except ValueError:
            log.warning("invalid VPTPU_KBPS=%r; using fixed QP", env_kbps)
            self.bitrate_kbps = 0.0
        if self.bitrate_kbps < 0:
            # a negative target would pin the controller at QP 29
            log.warning("negative stream bitrate %r; using fixed QP",
                        self.bitrate_kbps)
            self.bitrate_kbps = 0.0
        # GOP length (IDR interval) for the inter tier: config value when
        # given, else VPTPU_GOP, else 30. See VisionConfig.stream_gop for
        # the UDP loss-recovery tradeoff.
        self.gop = int(gop) if gop else 0
        self._last_encode_t = None   # measured encode cadence (rc input)
        self._rate_seeded = False    # first measured dt seeds the EWMA
        self._slot = _LatestSlot()
        self._seq = 0
        self._ssrc = np.random.randint(0, 2**31)
        self._encoder = None
        self._proc = None
        self._sock = None
        self._thread = None
        self.codec = codec or (self._pick_codec() if active else None)
        if active:
            log.info("RTP streamer: %s via %s", url, self.codec)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _pick_codec(self) -> str:
        """native H.264 -> external ffmpeg x264 -> RTP/JPEG (mirrors the
        reference's encoder cascade, reference src/rtpstreamer.cpp:62-93)."""
        # motion-compensated inter tier: IDR every VPTPU_GOP frames
        # (default 30 = one per second at the 30 fps stream rate; the
        # reference's x264 path emits inter frames likewise), P_Skip on
        # static macroblocks and integer-pel searched MVs on moving ones
        # — mostly-static field views shrink ~GOP-fold.
        # VPTPU_GOP=1 restores the all-intra stream. Parsed OUTSIDE the
        # encoder-probe try: a malformed value must not silently switch
        # the stream to a different codec path.
        # precedence matches the bitrate knob: VPTPU_GOP env override,
        # then the config value (stream: gop), then the 30-frame default
        gop_raw = os.environ.get("VPTPU_GOP", "")
        if gop_raw:
            try:
                gop = max(1, int(gop_raw))
            except ValueError:
                log.warning("invalid VPTPU_GOP=%r; using default 30", gop_raw)
                gop = 30
        else:
            gop = max(1, self.gop) if self.gop else 30
        try:
            from .native import H264Encoder

            self._encoder = H264Encoder(
                qp=self.qp, gop=gop,
                target_kbps=self.bitrate_kbps or None,
                framerate=self.framerate,
            )
            return "h264-native"
        except Exception:
            pass
        if shutil.which("ffmpeg") is not None:
            return "h264-ffmpeg"
        return "jpeg"

    def send_frame(self, rgb: np.ndarray) -> None:
        """Offer an (H, W, 3) uint8 RGB frame; never blocks."""
        if self.active:
            self._slot.offer(np.asarray(rgb))

    def close(self) -> None:
        self.active = False
        self._slot.close()
        if self._thread:
            self._thread.join(timeout=1.0)
        if self._proc:
            self._proc.terminate()
        if self._sock:
            self._sock.close()

    # -- encoder thread -----------------------------------------------------

    def _run(self) -> None:
        host, port = _parse_rtp_url(self.url)
        frame_interval = 1.0 / self.framerate
        while self.active:
            frame = self._slot.take()
            if frame is None:
                continue
            t0 = time.monotonic()
            try:
                if self.codec == "h264-native":
                    self._send_h264_native(frame, host, port)
                elif self.codec == "h264-ffmpeg":
                    self._send_h264(frame)
                else:
                    self._send_jpeg(frame, host, port)
            except Exception as exc:
                log.warning("RTP send failed: %s", exc)
            elapsed = time.monotonic() - t0
            if elapsed < frame_interval:
                time.sleep(frame_interval - elapsed)

    # -- JPEG/RTP (RFC 2435) ------------------------------------------------

    def _ensure_sock(self):
        if self._sock is None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setsockopt(
                socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, struct.pack("b", 32)
            )

    def _send_jpeg(self, rgb: np.ndarray, host: str, port: int) -> None:
        import cv2

        self._ensure_sock()
        h, w = rgb.shape[:2]
        ok, jpeg = cv2.imencode(
            ".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 80]
        )
        if not ok:
            return
        payload = _strip_jfif(jpeg.tobytes())
        ts = int(time.monotonic() * 90000) & 0xFFFFFFFF

        offset = 0
        total = len(payload)
        while offset < total:
            chunk = payload[offset : offset + MTU_PAYLOAD]
            last = offset + len(chunk) >= total
            # RTP header
            header = struct.pack(
                "!BBHII",
                0x80,
                RTP_JPEG_PT | (0x80 if last else 0),
                self._seq & 0xFFFF,
                ts,
                self._ssrc,
            )
            # JPEG payload header (RFC 2435): type 1 = 4:2:0, q=80 static-ish
            jpeg_hdr = struct.pack(
                "!BBBBBBBB",
                0,
                (offset >> 16) & 0xFF,
                (offset >> 8) & 0xFF,
                offset & 0xFF,
                1,  # type: baseline 4:2:0
                80,  # Q
                (w // 8) & 0xFF,
                (h // 8) & 0xFF,
            )
            # RFC 2435 header is type-specific; this compact form matches
            # common decoder expectations (type-specific=0, 24-bit offset)
            jpeg_hdr = (
                bytes([0])
                + offset.to_bytes(3, "big")
                + bytes([1, 80, (w // 8) & 0xFF, (h // 8) & 0xFF])
            )
            self._sock.sendto(header + jpeg_hdr + chunk, (host, port))
            self._seq += 1
            offset += len(chunk)

    # -- H.264 via the native in-process encoder (RFC 6184) ------------------

    def _send_h264_native(self, rgb: np.ndarray, host: str, port: int) -> None:
        self._ensure_sock()
        if self._encoder.target_kbps:
            # feed the MEASURED encode cadence into the rate controller:
            # round-robin multicam feeding (or frame drops on the 1-slot
            # queue) encodes each stream well below the nominal 30 fps,
            # and a per-frame budget at the wrong rate misses the target
            # by that factor
            t = time.monotonic()
            if self._last_encode_t is not None:
                dt = t - self._last_encode_t
                if 1e-3 < dt < 2.0:
                    fps = 1.0 / dt
                    if not self._rate_seeded:
                        # seed from the FIRST measured cadence: blending
                        # from the nominal 30 fps would leave the
                        # per-frame bit budget ~n_cams-times too small
                        # for dozens of frames under multicam round-robin
                        # feeding, transiently driving QP to the ceiling
                        self._encoder.framerate = fps
                        self._rate_seeded = True
                    else:
                        self._encoder.framerate = (
                            0.9 * self._encoder.framerate + 0.1 * fps)
            self._last_encode_t = t
        access_unit = self._encoder.encode_rgb(rgb)
        ts = int(time.monotonic() * 90000) & 0xFFFFFFFF
        for pkt in packetize_h264(access_unit, self._seq, ts, self._ssrc):
            self._sock.sendto(pkt, (host, port))
            self._seq += 1

    # -- H.264 via external ffmpeg ------------------------------------------

    def _send_h264(self, rgb: np.ndarray) -> None:
        h, w = rgb.shape[:2]
        if self._proc is None or self._proc.poll() is not None:
            self._proc = subprocess.Popen(
                [
                    "ffmpeg", "-loglevel", "error", "-f", "rawvideo",
                    "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
                    "-r", str(int(self.framerate)), "-i", "-",
                    "-c:v", "libx264", "-preset", "ultrafast",
                    "-tune", "zerolatency", "-f", "rtp", self.url,
                ],
                stdin=subprocess.PIPE,
            )
        self._proc.stdin.write(rgb.astype(np.uint8).tobytes())
        self._proc.stdin.flush()


def _strip_jfif(jpeg: bytes) -> bytes:
    """Strip everything before the scan data for RFC 2435 payloads: the
    receiver reconstructs headers from the payload header fields."""
    # find SOS marker (0xFFDA), include data after its segment
    i = 2
    while i < len(jpeg) - 1:
        if jpeg[i] != 0xFF:
            i += 1
            continue
        marker = jpeg[i + 1]
        if marker == 0xDA:
            seg_len = int.from_bytes(jpeg[i + 2 : i + 4], "big")
            return jpeg[i + 2 + seg_len :]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = int.from_bytes(jpeg[i + 2 : i + 4], "big")
        i += 2 + seg_len
    return jpeg
