"""Ingestion HTTP API.

Counterpart of the JAX package's ``serve/api.py``: the same stdlib
``ThreadingHTTPServer``, routes, uuid storage, sidecar fields and response
bodies. Routes:
    POST /upload   multipart file upload (+ optional metadata fields) ->
                   stored as data/raw/uploads/<uuid><ext> with a JSON
                   metadata sidecar <uuid>.json; responds {"id", "filename"}
    GET  /health   {"status": "ok"}

CLI: python -m audio_edge_ml_pipeline_torch.serve.api [--port 8000] [--data-dir data/raw/uploads]
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import uuid
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


def _parse_multipart(body: bytes, content_type: str) -> tuple[dict[str, bytes], dict[str, str], dict[str, str]]:
    """Minimal multipart/form-data parser -> (file bytes by field name,
    original filenames by field name, plain form fields)."""
    m = re.search(r"boundary=([^;]+)", content_type)
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = m.group(1).strip('"').encode()
    files: dict[str, bytes] = {}
    names: dict[str, str] = {}
    fields: dict[str, str] = {}
    for part in body.split(b"--" + boundary):
        # closing delimiter chunk starts with "--"; normal parts start with
        # the CRLF that followed the boundary line
        if not part or part.lstrip(b"\r\n ").startswith(b"--"):
            continue
        if part.startswith(b"\r\n"):
            part = part[2:]
        if b"\r\n\r\n" not in part:
            continue
        header_blob, content = part.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", "replace")
        nm = re.search(r'name="([^"]+)"', headers)
        if not nm:
            continue
        fname = re.search(r'filename="([^"]*)"', headers)
        # strip exactly the ONE CRLF that precedes the next boundary —
        # byte-preserving for binary payloads whose real tail bytes are
        # 0x0D/0x0A (an rstrip here truncated such uploads)
        if content.endswith(b"\r\n"):
            content = content[:-2]
        if fname:
            files[nm.group(1)] = content
            names[nm.group(1)] = fname.group(1)
        else:
            fields[nm.group(1)] = content.decode("utf-8", "replace")
    return files, names, fields


class IngestionHandler(BaseHTTPRequestHandler):
    data_dir: Path = Path("data/raw/uploads")

    def _json(self, code: int, payload: dict) -> None:
        blob = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        if self.path != "/upload":
            self._json(404, {"error": "not found"})
            return
        length = int(self.headers.get("Content-Length", 0))
        ctype = self.headers.get("Content-Type", "")
        body = self.rfile.read(length)
        try:
            if ctype.startswith("multipart/form-data"):
                files, names, fields = _parse_multipart(body, ctype)
            else:
                files, names, fields = {"file": body}, {"file": "upload.bin"}, {}
            if "file" not in files:
                self._json(400, {"error": "no 'file' field in upload"})
                return
            file_id = uuid.uuid4().hex
            orig_name = names.get("file", "upload.bin")
            ext = Path(orig_name).suffix or ".bin"
            self.data_dir.mkdir(parents=True, exist_ok=True)
            out = self.data_dir / f"{file_id}{ext}"
            out.write_bytes(files["file"])
            meta = {
                "id": file_id,
                "filename": orig_name,
                "stored_as": out.name,
                "size_bytes": len(files["file"]),
                "received_at": datetime.now().isoformat(timespec="seconds"),
                **fields,
            }
            (self.data_dir / f"{file_id}.json").write_text(json.dumps(meta, indent=2))
            logger.info("upload %s (%d bytes) -> %s", orig_name, len(files["file"]), out)
            self._json(200, {"id": file_id, "filename": orig_name})
        except Exception as exc:
            self._json(500, {"error": str(exc)})

    def log_message(self, fmt, *args):
        logger.debug(fmt, *args)


def create_server(data_dir: Path | str = "data/raw/uploads", port: int = 8000) -> ThreadingHTTPServer:
    handler = type("Handler", (IngestionHandler,), {"data_dir": Path(data_dir)})
    return ThreadingHTTPServer(("0.0.0.0", port), handler)


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.serve.api")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data-dir", default="data/raw/uploads")
    args = p.parse_args(argv)
    server = create_server(args.data_dir, args.port)
    logger.info("Ingestion API on :%d (uploads -> %s)", args.port, args.data_dir)
    server.serve_forever()


if __name__ == "__main__":
    main()
