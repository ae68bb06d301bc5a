"""tev remote-preview wire protocol (little-endian, length-prefixed TCP).

Parity with reference ``src/headless.rs:14-178``: the public tev IPC
protocol — CreateImage (header 4) and UpdateImage (header 3) packets,
channel updates streamed in 100x100 chunks.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

HEADER_OPEN = 0
HEADER_RELOAD = 1
HEADER_CLOSE = 2
HEADER_UPDATE = 3
HEADER_CREATE = 4

CHUNK_DIM = 100


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _packet(payload: bytes) -> bytes:
    return struct.pack("<i", len(payload) + 4) + payload


def create_image_packet(width: int, height: int, name: str = "render",
                        channels=("r", "g", "b")) -> bytes:
    payload = struct.pack("<B", HEADER_CREATE) + b"\x01" + _cstr(name)
    payload += struct.pack("<iii", width, height, len(channels))
    for c in channels:
        payload += _cstr(c)
    return _packet(payload)


def update_image_packets(rgb: np.ndarray, name: str = "render") -> list[bytes]:
    """Per-channel 100x100 chunk updates (ref headless.rs:121-164).

    rgb: (H, W, 3) float32 linear.
    """
    h, w = rgb.shape[:2]
    packets = []
    for idx, cname in enumerate(("r", "g", "b")):
        channel = np.ascontiguousarray(rgb[..., idx], np.float32)
        for x in range(0, w, CHUNK_DIM):
            for y in range(0, h, CHUNK_DIM):
                cw = min(CHUNK_DIM, w - x)
                ch = min(CHUNK_DIM, h - y)
                chunk = channel[y:y + ch, x:x + cw]
                payload = (struct.pack("<B", HEADER_UPDATE) + b"\x01"
                           + _cstr(name) + _cstr(cname)
                           + struct.pack("<iiii", x, y, cw, ch)
                           + chunk.astype("<f4").tobytes())
                packets.append(_packet(payload))
    return packets


class TevClient:
    """Best-effort TCP connection to a running tev instance."""

    def __init__(self, address: str = "127.0.0.1:14158"):
        host, port = address.rsplit(":", 1)
        self.sock: socket.socket | None = None
        try:
            self.sock = socket.create_connection((host, int(port)),
                                                 timeout=1.0)
        except OSError:
            self.sock = None

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def create_image(self, width: int, height: int, name: str = "render"):
        if self.sock:
            self.sock.sendall(create_image_packet(width, height, name))

    def update_image(self, rgb: np.ndarray, name: str = "render"):
        if self.sock:
            for pkt in update_image_packets(rgb, name):
                self.sock.sendall(pkt)

    def close(self):
        if self.sock:
            self.sock.close()
            self.sock = None
