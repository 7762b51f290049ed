"""Text and multimodal generation over HTTP (port of
leopard_tpu/inference/server.py, the same JSON in and out).

Prompts may carry `<image>` placeholders plus base64-encoded images, which
are prepared on the host and spliced on the device: anyres tiles for
Leopard-LLaVA (`data/anyres.py`), NaViT images with patch masks for
Leopard-Idefics2 (`data/idefics2_processor.py`).

  POST /api/generate
    {"prompts": ["what is in <image>?"],
     "images": [["<base64 png/jpeg>", ...]],        # optional, per prompt
     "max_new_tokens": 64,                          # int or per-prompt list
     "temperature": 1.0, "top_k": 0, "top_p": 0.0, "greedy": true}
  → {"text": [...], "logprobs": [[...]], "tokens": [[...]]}

  POST /api/chat: multi-turn sessions with conversation KV reuse; each turn
    prefills only the new message (see handle_chat)

  GET /health → {"status": "ok"}

Serving modes (one request at a time, queued in the socket backlog):
  - plain: one `Engine.generate` per request batch (sampling, repetition
    penalty, logprobs, speculative decode via `spec`);
  - continuous (`continuous=ContinuousEngine(...)`): the rows join the slot
    pool, each with its own `max_new_tokens`.

Pillow is imported only to decode posted images.
"""

from __future__ import annotations

import base64
import io
import json
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional, Tuple

import numpy as np

from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.data.anyres import preprocess_tiles_uint8, tile_images
from leopard_tpu_torch.data.chat import build_idefics2_prompt, render_images_into_text
from leopard_tpu_torch.data.idefics2_processor import preprocess_idefics2
from leopard_tpu_torch.inference.continuous import Request
from leopard_tpu_torch.inference.engine import Engine


def _decode_images(b64_list) -> list:
    if not b64_list:
        return []
    from PIL import Image

    return [
        Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB")
        for b in b64_list
    ]


def _gen_config(payload: dict, max_new_tokens: int) -> GenerateConfig:
    return GenerateConfig(
        max_new_tokens=max_new_tokens,
        temperature=float(payload.get("temperature", 1.0)),
        top_k=int(payload.get("top_k", 0)),
        top_p=float(payload.get("top_p", 0.0)),
        repetition_penalty=float(payload.get("repetition_penalty", 1.0)),
        greedy=bool(payload.get("greedy", True)),
        eos_token_ids=tuple(payload.get("eos_token_ids", (128001, 128009))),
        seed=int(payload.get("seed", 0)),
    )


class GenerationServer:
    def __init__(self, engine: Engine, tokenizer, host: str = "0.0.0.0",
                 port: int = 5000, continuous=None, spec=None, prefix=None):
        """`continuous`: a ContinuousEngine over the same model; requests go
        through its slot pool (per-row budgets, no repetition penalty or
        logprobs). `spec`: a SpecConfig for greedy plain-mode requests.
        `prefix`: an `Engine.build_prefix` result (a shared system prompt)
        put before every request from its cached KV; it excludes `spec` and
        repetition_penalty != 1.0."""
        self.engine = engine
        self.tokenizer = tokenizer
        self.host = host
        self.port = port
        self.continuous = continuous
        self.spec = spec
        self.prefix = prefix
        if prefix is not None and spec is not None:
            raise ValueError("prefix caching and speculative decoding are "
                             "mutually exclusive (n-gram history)")
        # /api/chat sessions: session_id → Prefix holding the dialogue so far.
        # Insertion order is LRU order: refreshed on a successful turn, the
        # oldest evicted past max_sessions (each session holds one cache).
        self._sessions: dict = {}
        self.max_sessions = 8

    def _prepare_row(self, text: str, pil_images: list
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        """Tokenize one prompt, splicing image-token blocks, and prepare its
        images. Returns (ids, pixels or None, patch mask or None): uint8
        NHWC anyres tiles for LLaVA; for Idefics2 normalized float32 NCHW
        images and their patch mask, with the `<image>` strings dropped
        from the text and one block of `num_latents` image tokens between
        fake-image tokens (id image_token_id - 1) put before it per image."""
        cfg = self.engine.cfg
        if not pil_images:
            ids = self.tokenizer(text, add_special_tokens=True)["input_ids"]
            return np.asarray(ids, np.int32), None, None
        if cfg.architecture == "leopard_idefics2":
            pixels, _, patch_mask = preprocess_idefics2(pil_images)
            ids = build_idefics2_prompt(
                self.tokenizer, text.replace("<image>", ""), len(pil_images),
                image_seq_len=cfg.perceiver.num_latents if cfg.perceiver else 64,
                image_token_id=cfg.image_token_id,
                fake_token_id=cfg.image_token_id - 1,
            )
            return np.asarray(ids, np.int32), pixels, patch_mask
        tiled = tile_images(
            pil_images, tile_size=cfg.anyres.tile_size,
            total_budget=cfg.anyres.tile_budget, order="eval",
        )
        pixels = preprocess_tiles_uint8(tiled.tiles, tile_size=cfg.anyres.tile_size)
        ids = render_images_into_text(
            self.tokenizer, text, tiled.tiles_per_image,
            cfg.anyres.tokens_per_tile, image_token_id=cfg.image_token_id,
            layout="eval",
        )
        return np.asarray(ids, np.int32), pixels, None

    def _decode_text(self, tokens: np.ndarray) -> str:
        return self.tokenizer.decode(tokens.tolist(), skip_special_tokens=True)

    def handle_generate(self, payload: dict) -> dict:
        prompts = payload["prompts"]
        images_b64 = payload.get("images") or [[]] * len(prompts)
        if len(images_b64) != len(prompts):
            raise ValueError("images must have one (possibly empty) list "
                             "per prompt")
        max_new = payload.get("max_new_tokens", 128)
        budgets = (list(max_new) if isinstance(max_new, (list, tuple))
                   else [int(max_new)] * len(prompts))
        if len(budgets) != len(prompts):
            raise ValueError("max_new_tokens list must have one entry per "
                             "prompt")
        gen = _gen_config(payload, max(int(b) for b in budgets))
        rows = [self._prepare_row(p, _decode_images(b))
                for p, b in zip(prompts, images_b64)]

        if self.continuous is not None:
            return self._generate_continuous(rows, budgets, gen)

        if self.prefix is not None and gen.repetition_penalty != 1.0:
            raise ValueError("repetition_penalty is unsupported when the "
                             "server holds a cached system-prompt prefix")
        with_px = [px for _, px, _ in rows if px is not None]
        pixels = np.concatenate(with_px, axis=0) if with_px else None
        masks = [pm for _, _, pm in rows if pm is not None]
        patch_mask = np.concatenate(masks, axis=0) if masks else None
        spec = self.spec if (gen.greedy and gen.repetition_penalty == 1.0) else None
        res = self.engine.generate([ids for ids, _, _ in rows], images=pixels,
                                   patch_mask=patch_mask, gen_cfg=gen, spec=spec,
                                   prefix=self.prefix)
        tokens = [t[: b] for t, b in zip(res.tokens, budgets)]
        return {
            "text": [self._decode_text(t) for t in tokens],
            "tokens": [t.tolist() for t in tokens],
            "logprobs": [l[: b].tolist()
                         for l, b in zip(res.logprobs or [], budgets)],
        }

    def handle_chat(self, payload: dict) -> dict:
        """Multi-turn chat with conversation KV reuse: each turn prefills only
        the new message against the session's cached dialogue
        (`Engine.generate(prefix=..., return_prefix=True)`).

          POST /api/chat
            {"session_id": "abc", "prompt": "...", "images": [...],
             "max_new_tokens": 64, "greedy": true}       # or {"reset": true}
          → {"text": "...", "tokens": [...], "context_tokens": N}

        Chat runs on the plain engine path, without speculative decode. The
        server's prefix seeds new sessions. The session is replaced only when
        the turn succeeds: a turn that raises leaves it as it was."""
        sid = str(payload["session_id"])
        if payload.get("reset"):
            self._sessions.pop(sid, None)
            return {"status": "reset"}
        if float(payload.get("repetition_penalty", 1.0)) != 1.0:
            raise ValueError("chat sessions do not support "
                             "repetition_penalty (prefix-cached history)")
        ids, pixels, patch_mask = self._prepare_row(
            payload["prompt"], _decode_images(payload.get("images") or [])
        )
        gen = _gen_config(payload, int(payload.get("max_new_tokens", 128)))
        res = self.engine.generate(
            [ids], images=pixels, patch_mask=patch_mask, gen_cfg=gen,
            prefix=self._sessions.get(sid) or self.prefix, return_prefix=True,
        )
        self._sessions.pop(sid, None)
        self._sessions[sid] = res.prefix          # re-insert = LRU refresh
        while len(self._sessions) > self.max_sessions:
            self._sessions.pop(next(iter(self._sessions)))
        return {
            "text": self._decode_text(res.tokens[0]),
            "tokens": res.tokens[0].tolist(),
            "context_tokens": res.prefix.length,
        }

    def _generate_continuous(self, rows, budgets, gen: GenerateConfig) -> dict:
        if gen.repetition_penalty != 1.0:
            raise ValueError("continuous mode does not support "
                             "repetition_penalty; send 1.0 or use the plain "
                             "server mode")
        reqs = [Request(prompt=ids, max_new_tokens=int(b), images=px, patch_mask=pm)
                for (ids, px, pm), b in zip(rows, budgets)]
        completions = self.continuous.run(reqs, gen_cfg=gen, prefix=self.prefix)
        return {
            "text": [self._decode_text(c.tokens) for c in completions],
            "tokens": [c.tokens.tolist() for c in completions],
            "logprobs": [],
        }

    def http_server(self) -> HTTPServer:
        """The HTTP server, bound to (host, port) and not yet serving; port 0
        takes a free port (`server_address` names it)."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, {"status": "ok"})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                handlers = {"/api/generate": outer.handle_generate,
                            "/api/chat": outer.handle_chat}
                handler = handlers.get(self.path)
                if handler is None:
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    self._reply(200, handler(payload))
                except Exception as e:  # noqa: BLE001 — reported to the client
                    traceback.print_exc()
                    self._reply(500, {"error": str(e)})

        return HTTPServer((self.host, self.port), Handler)

    def serve_forever(self):
        server = self.http_server()
        print(f"leopard-tpu-torch generation server on {self.host}:{server.server_address[1]}")
        try:
            server.serve_forever()
        finally:
            server.server_close()
