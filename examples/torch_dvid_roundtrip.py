"""DVID round trip on the PyTorch/CUDA port: fetch a grayscale cutout,
detect T-bars on the device, push them back as DVID synapse annotations
with partner PSDs, and read them back intact.

The port's counterpart of ``examples/dvid_roundtrip.py``: grayscale via
``/raw``, annotations via ``/elements`` with ``PreSynTo``/``PostSynTo``
relationships on both sides of each synapse.  It runs against an embedded
in-process mock DVID server on 127.0.0.1 (the standard library's
``http.server``); point ``--server`` at a DVID node to use one.

Run: python3 examples/torch_dvid_roundtrip.py [--device cuda] [--size 96]
"""

from __future__ import annotations

import argparse
from http.server import BaseHTTPRequestHandler, HTTPServer
import json
from pathlib import Path
import sys
import threading

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flypylib_tpu_torch import nms  # noqa: E402
from flypylib_tpu_torch.io import DVIDClient, Tbars  # noqa: E402


class MockDVID(BaseHTTPRequestHandler):
    """Minimal DVID node: /raw serves a synthetic uint8 volume, /elements
    stores and returns posted annotation elements."""

    volume: np.ndarray = None
    elements: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        if "raw" in parts:
            i = parts.index("raw")
            sx, sy, sz = map(int, parts[i + 2].split("_"))
            ox, oy, oz = map(int, parts[i + 3].split("_"))
            cut = self.volume[oz:oz + sz, oy:oy + sy, ox:ox + sx]
            data = np.ascontiguousarray(cut).tobytes()
        elif "elements" in parts:
            data = json.dumps(MockDVID.elements).encode()
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        MockDVID.elements.extend(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()


def synthetic_volume(size=96, n_blobs=12, seed=0):
    """uint8 (size,)*3 volume of Gaussian blobs at seeded centres."""
    rng = np.random.default_rng(seed)
    vol = np.zeros((size,) * 3, np.float32)
    centers = rng.integers(8, size - 8, (n_blobs, 3))
    g = np.arange(-6, 7)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    blob = np.exp(-(zz**2 + yy**2 + xx**2) / (2 * 2.0**2))
    for c in centers:
        sl = tuple(slice(c[i] - 6, c[i] + 7) for i in range(3))
        vol[sl] = np.maximum(vol[sl], blob)
    return (vol * 255).astype(np.uint8), centers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--server", default=None,
                    help="a DVID server (host:port); default: the embedded "
                         "mock")
    ap.add_argument("--uuid", default="abc123")
    ap.add_argument("--size", type=int, default=96)
    args = ap.parse_args()

    srv = None
    if args.server is None:
        MockDVID.volume, _ = synthetic_volume(args.size)
        MockDVID.elements = []
        srv = HTTPServer(("127.0.0.1", 0), MockDVID)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        args.server = f"127.0.0.1:{srv.server_port}"
        print(f"embedded mock DVID at {args.server}")
    try:
        client = DVIDClient(args.server, args.uuid)
        size = (args.size,) * 3
        gray = client.get_gray3d("grayscale", size=size, offset=(0, 0, 0))
        print(f"fetched cutout {gray.shape} {gray.dtype}, mean {gray.mean():.1f}")

        # "detect" T-bars: NMS on the normalised intensity, on the device
        # (swap in FplNetwork.detect for a trained model)
        prob = torch.from_numpy(gray.astype(np.float32) / 255.0).to(args.device)
        det = nms(prob, window=5, threshold=0.5)
        partners = [np.asarray([[z, y, min(x + 3, args.size - 1)]])
                    for (z, y, x) in det.locs]
        det = Tbars(locs=det.locs, conf=det.conf, partners=partners)
        print(f"detected {len(det)} T-bars (+1 partner PSD each) on "
              f"{prob.device}")

        client.post_annotations("synapses", det)
        back = client.get_annotations("synapses", size=size, offset=(0, 0, 0))
        assert len(back) == len(det)
        np.testing.assert_array_equal(back.locs, det.locs)
        np.testing.assert_allclose(back.conf, det.conf)
        for a, b in zip(back.partners, det.partners):
            np.testing.assert_array_equal(a, b)
        print("round trip OK: locations, confidences and partner PSDs identical")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()


if __name__ == "__main__":
    main()
