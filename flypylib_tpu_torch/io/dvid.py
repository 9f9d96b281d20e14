"""Minimal DVID HTTP client.

Counterpart of ``flypylib_tpu/io/dvid.py``, copied (the standard library
and numpy only, with the port's ``io/synapses.py``).  flypylib fplsynapses
fetches grayscale cutouts from a DVID server
and pushes detected synapses back as DVID annotation elements (SURVEY.md
section 2.2 row 4, section 3.4).  Implemented over ``urllib`` (stdlib) so it
carries no extra dependency; tested against a local mock HTTP server.

Endpoints used (DVID REST API):

- ``GET  /api/node/{uuid}/{instance}/raw/0_1_2/{sx}_{sy}_{sz}/{ox}_{oy}_{oz}``
  -> raw uint8 bytes in x-fastest order for a grayscale cutout.
- ``GET  /api/node/{uuid}/{instance}/elements/{sx}_{sy}_{sz}/{ox}_{oy}_{oz}``
  -> JSON list of annotation elements.
- ``POST /api/node/{uuid}/{instance}/elements`` <- JSON list of elements.
"""

from __future__ import annotations

import gzip
import json
import logging
import time
import urllib.error
import urllib.request

import numpy as np

from flypylib_tpu_torch.io.synapses import Tbars, load_from_json, save_to_json

logger = logging.getLogger("flypylib_tpu_torch")


class DVIDClient:
    """DVID client with retry/backoff + gzip transfer.

    ``retries`` transient failures (connection errors, HTTP 5xx/429) are
    retried with exponential backoff — long multi-ROI streams must survive
    server hiccups.  Both GET and POST
    retries are safe: cutout/elements GETs are reads and the elements
    POST is idempotent (DVID upserts by coordinate).
    """

    def __init__(self, server: str, uuid: str, timeout: float = 60.0,
                 retries: int = 4, backoff: float = 0.5,
                 gzip_ok: bool = True):
        if not server.startswith(("http://", "https://")):
            server = "http://" + server
        self.server = server.rstrip("/")
        self.uuid = uuid
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.gzip_ok = gzip_ok

    def _url(self, instance: str, path: str) -> str:
        return f"{self.server}/api/node/{self.uuid}/{instance}/{path}"

    def _request(self, url: str, payload: bytes | None = None) -> bytes:
        headers = {"Content-Type": "application/json"} if payload else {}
        if self.gzip_ok:
            headers["Accept-Encoding"] = "gzip"
        last_err: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                req = urllib.request.Request(
                    url, data=payload, headers=headers
                )
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    body = r.read()
                    if r.headers.get("Content-Encoding") == "gzip":
                        body = gzip.decompress(body)
                    return body
            except urllib.error.HTTPError as e:
                # 4xx (except 429) are permanent; 5xx/429 transient
                if e.code != 429 and e.code < 500:
                    raise
                last_err = e
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last_err = e
            if attempt < self.retries:
                delay = self.backoff * (2 ** attempt)
                logger.warning(
                    "DVID %s failed (%s); retry %d/%d in %.1fs",
                    url, last_err, attempt + 1, self.retries, delay,
                )
                time.sleep(delay)
        raise IOError(
            f"DVID request failed after {self.retries + 1} attempts: {url}"
        ) from last_err

    def _get(self, url: str) -> bytes:
        return self._request(url)

    def _post(self, url: str, payload: bytes) -> bytes:
        return self._request(url, payload)

    def get_gray3d(self, instance: str, size, offset) -> np.ndarray:
        """Fetch a grayscale cutout as a (z, y, x) uint8 volume.

        ``size`` and ``offset`` are (z, y, x); the URL uses DVID's
        x/y/z order.
        """
        sz, sy, sx = (int(v) for v in size)
        oz, oy, ox = (int(v) for v in offset)
        url = self._url(instance, f"raw/0_1_2/{sx}_{sy}_{sz}/{ox}_{oy}_{oz}")
        raw = self._get(url)
        expected = sx * sy * sz
        if len(raw) != expected:
            raise IOError(
                f"DVID returned {len(raw)} bytes, expected {expected}"
            )
        return np.frombuffer(raw, dtype=np.uint8).reshape(sz, sy, sx)

    def get_annotations(self, instance: str, size, offset) -> Tbars:
        """Fetch annotation elements in a box as T-bars (z, y, x coords)."""
        sz, sy, sx = (int(v) for v in size)
        oz, oy, ox = (int(v) for v in offset)
        url = self._url(instance, f"elements/{sx}_{sy}_{sz}/{ox}_{oy}_{oz}")
        obj = json.loads(self._get(url) or b"[]")
        return load_from_json(obj if obj is not None else [])

    def post_annotations(self, instance: str, tbars: Tbars) -> None:
        """Push detections as DVID annotation elements.

        Emits PreSyn elements plus, when ``tbars.partners`` is set,
        their PSDs as PostSyn elements with ``PreSynTo``/``PostSynTo``
        relationships on both sides (full DVID synapse structure)."""
        payload = json.dumps(save_to_json(tbars, style="dvid")).encode()
        self._post(self._url(instance, "elements"), payload)
