"""The vision bus's other end, as a process of its own: it publishes the
field geometry and records every detection frame that the cameras send.

Run by ``run.py`` before the set-up starts:

    python bus.py GROUP PORT GEOMETRY_FILE RECORD_FILE

It joins GROUP:PORT and prints ``ready``. Until a line ``calibrated``
comes on its standard input it sends the geometry packet (the file's
bytes) every 50 ms, as a geometry publisher does. It records each
detection frame with its receive time on the host's monotonic clock:
camera, frame number, the capture times, the balls and the robots. A line
``finish`` makes it read on until the bus has been quiet for 0.5 s (2 s at
most), write the record to RECORD_FILE as JSON, print ``done`` and exit.
It imports neither torch nor the program, so the measured process neither
reads nor parses a packet.
"""
from __future__ import annotations

import json
import select
import socket
import struct
import sys
import time

from wire import decode_detection


def open_bus(group: str, port: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, struct.pack("b", 1))
    sock.bind((group, port))
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                    struct.pack("4sl", socket.inet_aton(group), socket.INADDR_ANY))
    return sock


def main(argv: list[str]) -> int:
    group, port, geometry_file, record_file = argv[1], int(argv[2]), argv[3], argv[4]
    with open(geometry_file, "rb") as fh:
        geometry = fh.read()
    sock = open_bus(group, port)
    frames, geometry_seen = [], 0
    publishing, finishing = True, None
    next_send = 0.0
    print("ready", flush=True)
    stdin = sys.stdin.buffer
    while True:
        now = time.monotonic()
        if publishing and now >= next_send:
            sock.sendto(geometry, (group, port))
            next_send = now + 0.05
        if finishing is not None:
            timeout = min(finishing[0] + 2.0, finishing[1] + 0.5) - now
            if timeout <= 0:
                break
        else:
            timeout = max(next_send - now, 0.0) if publishing else 1.0
        ready, _, _ = select.select([sock, stdin], [], [], timeout)
        if sock in ready:
            data = sock.recv(65536)
            t = time.monotonic()
            det = decode_detection(data)
            if det is None:
                geometry_seen += 1
            else:
                det["t_receive"] = t
                frames.append(det)
            if finishing is not None:
                finishing[1] = t
        if stdin in ready:
            line = stdin.readline().strip()
            if line == b"calibrated":
                publishing = False
            elif line in (b"finish", b""):  # an empty read: the parent is gone
                publishing = False
                finishing = [time.monotonic(), time.monotonic()]
    sock.close()
    with open(record_file, "w") as fh:
        json.dump({"frames": frames, "geometry_packets_seen": geometry_seen}, fh)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
