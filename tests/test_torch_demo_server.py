"""The port's serving entry point (``helpers/gradio_demo/app_torch.py``) and
push scripts (``helpers/push_to_hub_scripts/*_torch.py``) on the CPU at fp32,
against the JAX package's.

A tiny artifact (``tests/test_pipeline.py``'s, with a greedy generation
config, made audible as ``tests/test_torch_streaming.py``'s ``loud`` model
is) is saved by the JAX package and carried into the port by
``core/from_jax``.  One request to the port's ``POST /api`` and to JAX's
``run_http`` give WAVs of the same rate and length whose samples differ by
at most 1 int16 LSB (the truncating pcm16 cast of fp32 waveforms that
agree to 1e-5); the port's bytes are those of its engine's direct ``tts``;
``GET /stats`` is ``engine.stats()``; ``POST /`` embeds the same WAV.
``main`` takes the HTTP path with no gradio installed (with ``--warmup``
every bucket once) and ``run_gradio`` when it is.  The push scripts run
in-process against a stand-in ``huggingface_hub`` that records the upload
or refuses it, so nothing reaches the network; the DAC script's output is
held against the JAX script's on a tiny ``DacModel`` directory.
"""

from __future__ import annotations

import base64
import importlib.util
import io
import json
import os
import re
import sys
import threading
import time
import types
import urllib.parse
import urllib.request
from http.server import HTTPServer

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import checkpoint as jck
from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.models import dac as jdac
from parler_tts_tpu.models import parler as jparler
from parler_tts_tpu.pipeline import ParlerTTSPipeline as JaxPipeline
from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.models import dac as pdac
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils.audio_io import read_wav, wav_bytes
from tests.test_torch_streaming import _scale_kernels

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUEST = dict(description="a female speaker with a low pitched voice", prompt="hey how are you doing today",
               seed="1", max_seconds="0.01")
DAC_DECODE_TOL = 1e-5  # tests/test_torch_blocks.py::test_dac_decode_matches_jax


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def app():
    return _load("helpers/gradio_demo/app_torch.py", "app_torch")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(JAX artifact, port artifact): ``tests/test_pipeline.py``'s tiny
    model and WordPiece tokenizer, greedy; the codec's decode-side kernels
    scaled by 10 (audio about 0.1, not 1e-7, which pcm16 would make 0) and
    the special ids' LM-head columns zeroed (samples run to the length
    asked for)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    base = tmp_path_factory.mktemp("demo")
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(["a female speaker with a low pitched voice", "hey how are you doing today",
                             "clear audio quality speaks fast"],
                            trainers.WordPieceTrainer(vocab_size=150, special_tokens=["[UNK]", "[PAD]", "</s>"]))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]", eos_token="</s>")
    cfg = jcfg.ParlerTTSConfig(
        vocab_size=160,
        text_encoder=jcfg.T5EncoderConfig(vocab_size=160, d_model=24, d_kv=6, d_ff=48, num_layers=1, num_heads=4),
        audio_encoder=jcfg.DACConfig(num_codebooks=4, codebook_size=32, codebook_dim=4, latent_dim=16,
                                     encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=16,
                                     upsampling_ratios=(4, 2), sampling_rate=16000, frame_rate=2000),
        decoder=jcfg.DecoderConfig(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                                   ffn_dim=64, num_codebooks=4, max_position_embeddings=256, pad_token_id=32,
                                   eos_token_id=32, bos_token_id=33, dropout=0.0),
    )
    params = jax.tree.map(np.asarray, jparler.init(jax.random.PRNGKey(0), cfg))
    codec = params["audio_encoder"]
    params["audio_encoder"] = {**codec, "decoder": _scale_kernels(codec["decoder"], 10.0),
                               "quantizer": {**codec["quantizer"], "out_proj": _scale_kernels(
                                   codec["quantizer"]["out_proj"], 10.0)}}
    heads = np.array(params["decoder"]["lm_heads"]["kernel"])
    heads[..., cfg.audio_encoder.codebook_size:] = 0.0
    params["decoder"] = {**params["decoder"], "lm_heads": {"kernel": heads}}
    gen = jcfg.GenerationConfig(max_length=20, do_sample=False, decoder_start_token_id=33, pad_token_id=32,
                                bos_token_id=33, eos_token_id=32)
    jax_dir, port_dir = str(base / "jax"), str(base / "port")
    jck.save_model(jax_dir, params, cfg, gen, tokenizer=fast)
    port_cfg = pcfg.ParlerTTSConfig.from_dict(cfg.to_dict())
    model = ParlerTTSModel(port_cfg)
    load_jax_params(model, params)
    ck.save_model(port_dir, model, port_cfg, pcfg.GenerationConfig.from_dict(gen.to_dict()))
    ck.carry_side_files(jax_dir, port_dir)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def port_server(app, artifacts):
    """The port's server over its engine on 127.0.0.1:0, in a thread."""
    pipe = ParlerTTSPipeline.from_pretrained(artifacts[1], dtype=torch.float32, pcm16=True, device="cpu")
    engine = app.make_engine(pipe)
    server = app.make_http_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, engine
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(port: int, path: str, fields: dict) -> tuple[str, bytes]:
    data = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.headers["Content-Type"], resp.read()


def _jax_api_wav(artifacts) -> bytes:
    """One ``POST /api`` to JAX's ``run_http``, wired as
    ``tests/test_pipeline.py::test_demo_http_server`` wires it (the bind
    redirected to 127.0.0.1:0, here for one server only), then stopped."""
    demo = _load("helpers/gradio_demo/app.py", "demo_app")
    pipe = JaxPipeline.from_pretrained(artifacts[0], dtype=np.float32, pcm16=True)
    holder = {}
    orig_init = HTTPServer.__init__

    def patched_init(self, addr, handler):
        HTTPServer.__init__ = orig_init
        orig_init(self, ("127.0.0.1", 0), handler)
        holder["server"] = self

    HTTPServer.__init__ = patched_init
    thread = threading.Thread(target=demo.run_http, args=(pipe, 0), daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if "server" in holder:
                break
            time.sleep(0.1)
        kind, body = _post(holder["server"].server_address[1], "/api", REQUEST)
        assert kind == "audio/wav"
        return body
    finally:
        HTTPServer.__init__ = orig_init
        if "server" in holder:
            holder["server"].shutdown()
            holder["server"].server_close()
        thread.join(timeout=30)


def test_api_matches_the_jax_server_and_the_engine(port_server, artifacts):
    """``POST /api``: the JAX server's WAV within 1 LSB at the same rate and
    length; the engine's direct ``tts`` as WAV bytes, bit for bit; then
    ``GET /stats`` is ``engine.stats()``."""
    server, engine = port_server
    port = server.server_address[1]
    kind, body = _post(port, "/api", REQUEST)
    assert kind == "audio/wav"
    sr, wav = engine.tts(REQUEST["description"], REQUEST["prompt"], seed=int(REQUEST["seed"]),
                         max_seconds=float(REQUEST["max_seconds"]))
    assert wav.dtype == np.int16 and wav.size > 0
    assert body == wav_bytes(wav, sr)

    jax_body = _jax_api_wav(artifacts)
    (got,), got_sr = read_wav(io.BytesIO(body))
    (ref,), ref_sr = read_wav(io.BytesIO(jax_body))
    assert got_sr == ref_sr == 16000 and got.shape == ref.shape
    lsb = np.abs(np.round(got * 32768) - np.round(ref * 32768))
    print(f"{got.size} samples, peak {np.abs(wav).max()} LSB; {int((lsb > 0).sum())} differ from JAX's by 1 LSB")
    assert lsb.max() <= 1

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as resp:
        assert resp.headers["Content-Type"] == "application/json"
        stats = json.loads(resp.read())
    assert stats == engine.stats() and stats["requests"] == 2 and stats["batches"] == 2


def test_form_embeds_the_same_wav(port_server):
    """``POST /`` returns the form with the ``/api`` bytes as a base64
    ``<audio>`` source; ``GET /`` the empty form."""
    server, _ = port_server
    port = server.server_address[1]
    _, api = _post(port, "/api", REQUEST)
    kind, page = _post(port, "/", REQUEST)
    assert kind == "text/html; charset=utf-8"
    (b64,) = re.findall(r'<audio controls src="data:audio/wav;base64,([A-Za-z0-9+/=]+)"></audio>', page.decode())
    assert base64.b64decode(b64) == api
    assert REQUEST["prompt"] in page.decode()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60) as resp:
        empty = resp.read().decode()
    assert "<form" in empty and "<audio" not in empty


def test_main_serves_http_without_gradio(app, artifacts, monkeypatch, capsys):
    """No gradio here: ``main`` loads the artifact with ``pcm16`` on the
    device asked for, warms every (batch, length) bucket once and serves."""
    assert importlib.util.find_spec("gradio") is None
    served = []
    monkeypatch.setattr(app.ThreadingHTTPServer, "serve_forever", lambda self: served.append(self.server_address))
    monkeypatch.setattr(app, "run_gradio", lambda *a, **k: pytest.fail("took the gradio path"))
    app.main([artifacts[1], "--port", "0", "--warmup", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(served) == 1 and served[0][1] > 0
    assert len(re.findall(r"^  bucket \d+x[\d.]+: ", out, re.M)) == 4 * 3
    assert f"serving on http://0.0.0.0:{served[0][1]}" in out


def test_main_takes_gradio_when_installed(app, monkeypatch, capsys):
    """With gradio importable, ``main`` calls ``run_gradio``: the pipeline
    loaded with ``pcm16``, a warmup and a callback, each one ``tts`` of
    batch 1 at 10 s (a stand-in pipeline records them: the tiny model has
    no positions for 10 s)."""
    calls, launched = [], {}

    class Pipe:
        device = torch.device("cpu")

        def tts(self, description, prompt, *, seed=0, max_seconds=None):
            calls.append((description, prompt, seed, max_seconds))
            return 16000, [np.full(8, len(calls), np.int16)]

    def from_pretrained(model_dir, **kw):
        launched["load"] = (model_dir, kw)
        return Pipe()

    class Interface:
        def __init__(self, fn, inputs, outputs):
            launched["fn"] = fn

        def launch(self, server_port):
            launched["port"] = server_port

    fake = types.ModuleType("gradio")
    fake.Interface, fake.Text, fake.Number, fake.Audio = Interface, dict, dict, dict
    monkeypatch.setitem(sys.modules, "gradio", fake)
    real = importlib.util.find_spec
    monkeypatch.setattr(app.importlib.util, "find_spec", lambda name, *a: fake if name == "gradio" else real(name, *a))
    monkeypatch.setattr(app, "run_http", lambda *a, **k: pytest.fail("took the HTTP path"))
    monkeypatch.setattr(app.ParlerTTSPipeline, "from_pretrained", from_pretrained)
    app.main(["some_dir", "--port", "7861", "--warmup", "--device", "cpu"])
    assert launched["load"] == ("some_dir", dict(tokenizer_name=None, pcm16=True, device="cpu"))
    assert launched["port"] == 7861 and "warm in" in capsys.readouterr().out
    sr, wav = launched["fn"]("say this", "a voice", 3.0)
    assert sr == 16000 and np.array_equal(wav, np.full(8, 2, np.int16))
    assert calls == [(app.DEFAULT_DESCRIPTION, "Warming up the server.", 0, 10.0), ("a voice", "say this", 3, 10.0)]


class _Hub:
    """A stand-in ``huggingface_hub`` whose uploads are recorded, or refused
    with ``refuse``: the scripts never reach the network here."""

    def __init__(self, refuse: str | None = None):
        self.uploads, self.refuse = [], refuse
        self.module = types.ModuleType("huggingface_hub")
        hub = self

        class HfApi:
            def upload_folder(self, *, folder_path, repo_id):
                if hub.refuse:
                    raise ConnectionError(hub.refuse)
                hub.uploads.append((folder_path, repo_id))

        self.module.HfApi = HfApi


@pytest.mark.parametrize("refuse", ["no network here", None])
def test_push_trained_validates_then_pushes_or_skips(artifacts, monkeypatch, capsys, refuse):
    script = _load("helpers/push_to_hub_scripts/push_trained_parler_tts_to_hub_torch.py", "push_trained_torch")
    hub = _Hub(refuse)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
    rc = script.main([artifacts[1], "someone/tiny-parler", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert "artifact OK: decoder 1L/32h, 4 codebooks" in out
    if refuse:
        assert rc == 1 and f"push skipped ({refuse})" in err and not hub.uploads
    else:
        assert rc == 0 and "pushed to someone/tiny-parler" in out and hub.uploads == [(artifacts[1],
                                                                                       "someone/tiny-parler")]


def test_push_trained_refuses_a_broken_artifact(artifacts, tmp_path):
    script = _load("helpers/push_to_hub_scripts/push_trained_parler_tts_to_hub_torch.py", "push_trained_torch")
    broken = tmp_path / "broken"
    broken.mkdir()
    for name in ("config.json", "generation_config.json"):
        (broken / name).write_text(open(os.path.join(artifacts[1], name)).read())
    with pytest.raises(FileNotFoundError):
        script.main([str(broken), "someone/tiny-parler", "--device", "cpu"])


@pytest.fixture(scope="module")
def hf_dac_dir(tmp_path_factory):
    """A tiny random HF ``DacModel`` saved locally (safetensors)."""
    from transformers import DacConfig, DacModel

    d = str(tmp_path_factory.mktemp("hf_dac"))
    torch.manual_seed(3)
    DacModel(DacConfig(n_codebooks=4, hidden_size=16, encoder_hidden_size=8, downsampling_ratios=[2, 4],
                       decoder_hidden_size=16, upsampling_ratios=[4, 2], codebook_size=32, codebook_dim=4,
                       sampling_rate=16000)).save_pretrained(d)
    return d


def test_push_dac_matches_the_jax_script(hf_dac_dir, tmp_path, monkeypatch, capsys):
    """The same source through both scripts: ``config.json`` equal as JSON;
    the port's ``weights.pt`` loads strictly into ``DAC(cfg)``, and its
    decode of fixed codes is JAX's ``dac.decode`` on the JAX script's
    params; ``--push`` without the network says so and still converts."""
    import orbax.checkpoint as ocp

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["push_dac_to_hub.py", hf_dac_dir, jax_out])
    _load("helpers/push_to_hub_scripts/push_dac_to_hub.py", "push_dac").main()
    hub = _Hub("no network here")
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
    _load("helpers/push_to_hub_scripts/push_dac_to_hub_torch.py", "push_dac_torch").main(
        [hf_dac_dir, port_out, "--push", "someone/tiny-dac"])
    out, err = capsys.readouterr()
    assert f"converted {hf_dac_dir} -> {port_out}" in out and "push skipped (no network here)" in err

    with open(os.path.join(jax_out, "config.json")) as f, open(os.path.join(port_out, "config.json")) as g:
        jax_json, port_json = json.load(f), json.load(g)
    assert port_json == jax_json
    cfg = pcfg.DACConfig.from_dict(port_json)
    codec = pdac.DAC(cfg)
    codec.load_state_dict(torch.load(os.path.join(port_out, ck.WEIGHTS_FILE), weights_only=True), strict=True)
    with ocp.PyTreeCheckpointer() as ckptr:
        params = ckptr.restore(os.path.abspath(os.path.join(jax_out, "weights")))
    codes = np.random.default_rng(4).integers(0, cfg.codebook_size, (2, cfg.num_codebooks, 11))
    ref = np.asarray(jdac.decode(params, jcfg.DACConfig.from_dict(jax_json), codes))
    got = codec.decode(torch.from_numpy(codes)).detach().numpy()
    assert got.shape == ref.shape == (2, 11 * cfg.hop_length)
    np.testing.assert_allclose(got, ref, atol=DAC_DECODE_TOL, rtol=0)
