"""Interactive TTS demo on the PyTorch port: description + prompt in, audio
out.  The counterpart of ``helpers/gradio_demo/app.py``, with its CLI,
routes and buckets.

Uses Gradio when it is installed; otherwise a stdlib HTTP server over the
batching engine serves the same flow:

* ``POST /api`` (form fields ``description``, ``prompt``, ``seed``,
  ``max_seconds``) returns the audio as ``audio/wav`` bytes;
* ``POST /`` returns the HTML form with the audio embedded as a base64
  ``<audio>`` tag; ``GET /`` the empty form;
* ``GET /stats`` returns the engine's counters as JSON.

The pipeline converts waveforms to 16-bit PCM on the card (``pcm16=True``),
so the WAV bytes are written as they come back.

Usage: python helpers/gradio_demo/app_torch.py <model_dir> [--tokenizer <dir>]
       [--port 7860] [--warmup] [--device cpu]
"""

import argparse
import base64
import html
import importlib.util
import json
import os
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline  # noqa: E402
from parler_tts_tpu_torch.serving import BatchingEngine  # noqa: E402
from parler_tts_tpu_torch.utils.audio_io import wav_bytes  # noqa: E402

DEFAULT_DESCRIPTION = (
    "A female speaker with a slightly low-pitched voice delivers her words "
    "quite expressively, in a very confined sounding environment with clear "
    "audio quality."
)
DEFAULT_PROMPT = "Hey, how are you doing today?"

FORM = """<!doctype html><title>Parler-TTS (H100)</title>
<h1>Parler-TTS — PyTorch on the H100</h1>
<form method="post">
<p>Description:<br><textarea name="description" rows="3" cols="80">{desc}</textarea></p>
<p>Prompt (what to say):<br><textarea name="prompt" rows="2" cols="80">{prompt}</textarea></p>
<p>Seed: <input name="seed" value="0" size="6">
   Max seconds: <input name="max_seconds" value="10" size="6">
   <input type="submit" value="Generate"></p>
</form>
{audio}
"""


def make_engine(pipe: ParlerTTSPipeline) -> BatchingEngine:
    """The server's engine: concurrent requests coalesce into batched
    ``tts`` calls.  ``--warmup`` covers exactly these buckets, so no request
    lands in a shape that was never run."""
    return BatchingEngine(pipe, max_batch=64, batch_buckets=(1, 4, 16, 64),
                          length_bucket_seconds=(5.0, 10.0, 30.0))


def make_http_server(engine: BatchingEngine, host: str, port: int) -> ThreadingHTTPServer:
    """The demo's routes over ``engine``, bound to ``(host, port)`` (port 0
    takes a free one: ``server.server_address``).  The caller runs
    ``serve_forever`` and, when done, ``shutdown`` and ``server_close``; the
    handler threads only submit to the engine, whose worker drives the
    card."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/stats":
                body = json.dumps(engine.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
                return
            self._page("")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            q = parse_qs(self.rfile.read(length).decode())
            desc = q.get("description", [DEFAULT_DESCRIPTION])[0]
            prompt = q.get("prompt", [DEFAULT_PROMPT])[0]
            seed = int(q.get("seed", ["0"])[0])
            secs = float(q.get("max_seconds", ["10"])[0])
            sr, wav = engine.tts(desc, prompt, seed=seed, max_seconds=secs)
            if self.path == "/api":
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.end_headers()
                self.wfile.write(wav_bytes(wav, sr))
                return
            b64 = base64.b64encode(wav_bytes(wav, sr)).decode()
            audio_tag = f'<audio controls src="data:audio/wav;base64,{b64}"></audio>'
            self._page(audio_tag, desc=desc, prompt=prompt)

        def _page(self, audio_tag, desc=DEFAULT_DESCRIPTION, prompt=DEFAULT_PROMPT):
            body = FORM.format(desc=html.escape(desc), prompt=html.escape(prompt), audio=audio_tag).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def run_http(pipe: ParlerTTSPipeline, port: int, warmup: bool = False) -> None:
    engine = make_engine(pipe)
    try:
        if warmup:
            # one batch of every (batch x length) bucket before traffic: the
            # first request of a shape would otherwise pay for the kernels'
            # build, cuDNN's choice of algorithms and the allocator's blocks
            print(f"warming up bucket programs (batch {engine.batch_buckets} x "
                  f"{engine.length_bucket_seconds} s)...", flush=True)
            for bucket, secs in sorted(engine.warmup().items()):
                print(f"  bucket {bucket}: {secs:.1f}s", flush=True)
        server = make_http_server(engine, "0.0.0.0", port)
        try:
            print(f"serving on http://0.0.0.0:{server.server_address[1]}  "
                  "(POST /api returns raw WAV; GET /stats)", flush=True)
            server.serve_forever()
        finally:
            server.server_close()
    finally:
        engine.shutdown()


def run_gradio(pipe: ParlerTTSPipeline, port: int, warmup: bool = False) -> None:
    import gradio as gr

    # the callback runs batch 1 at a fixed length, so the warmup runs that shape
    callback_seconds = 10.0

    def on_device():
        # gradio calls back from its own threads; the CUDA device is per thread
        if pipe.device.type == "cuda":
            torch.cuda.set_device(pipe.device)

    if warmup:
        print(f"warming up the batch-1 {callback_seconds:g} s program...", flush=True)
        t0 = time.monotonic()
        on_device()
        pipe.tts(DEFAULT_DESCRIPTION, "Warming up the server.", max_seconds=callback_seconds)
        print(f"  warm in {time.monotonic() - t0:.1f}s", flush=True)

    def gen(prompt, description, seed):
        on_device()
        sr, wavs = pipe.tts(description, prompt, seed=int(seed), max_seconds=callback_seconds)
        return sr, wavs[0]

    gr.Interface(
        fn=gen,
        inputs=[gr.Text(label="Prompt"), gr.Text(label="Description", value=DEFAULT_DESCRIPTION),
                gr.Number(label="Seed", value=0)],
        outputs=gr.Audio(label="Generated audio"),
    ).launch(server_port=port)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--warmup", action="store_true", help="run every bucket once before serving")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pipe = ParlerTTSPipeline.from_pretrained(args.model_dir, tokenizer_name=args.tokenizer, pcm16=True,
                                             device=args.device)
    if importlib.util.find_spec("gradio") is None:
        run_http(pipe, args.port, warmup=args.warmup)
    else:
        run_gradio(pipe, args.port, warmup=args.warmup)


if __name__ == "__main__":
    sys.exit(main())
