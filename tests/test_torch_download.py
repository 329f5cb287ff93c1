"""The port's dataset acquisition (data/download.py, `prep download`)
against the JAX package's, on archives the tests build (tests/
flac_fixture.py's FLAC encoder) and a localhost HTTP server: nothing is
fetched from beyond 127.0.0.1. The six cases of tests/test_download.py,
each run through both packages where it makes files: the extracted file
lists equal, the converted wavs' names and decoded samples equal (the
native decoder and the same resampler on both sides).
"""
import io
import tarfile
import threading
import zipfile
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import numpy as np
import pytest

from flac_fixture import encode as flac_encode
from speech_inpainting_tpu.data import download as jdl
from speech_inpainting_torch.cli import prep
from speech_inpainting_torch.data import download as pdl
from speech_inpainting_torch.data.audio import load_wav


def _tone(n=4800, sr=48000):
    t = np.arange(n)
    return (8000 * np.sin(2 * np.pi * 220 * t / sr)).astype(np.int64)


def _make_vctk_zip(path):
    """A VCTK-0.92-style archive: the flacs in a zip nested in the zip."""
    inner = io.BytesIO()
    with zipfile.ZipFile(inner, "w") as z:
        for spk in ("p225", "p226"):
            for txt in ("001", "002"):
                z.writestr(
                    f"wav48_silence_trimmed/{spk}/{spk}_{txt}_mic1.flac",
                    flac_encode([_tone()], sr=48000, modes=["fixed2"]))
                z.writestr(
                    f"wav48_silence_trimmed/{spk}/{spk}_{txt}_mic2.flac",
                    flac_encode([_tone()], sr=48000))
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("VCTK-0.92/inner.zip", inner.getvalue())
        z.writestr("VCTK-0.92/readme.txt", "fixture")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_datasets_match_jax():
    assert pdl.DATASETS == jdl.DATASETS


def test_extract_tar_bz2(tmp_path):
    payload = tmp_path / "LJ.tar.bz2"
    src = tmp_path / "stage" / "LJSpeech-1.1" / "wavs"
    src.mkdir(parents=True)
    (src / "LJ001-0001.wav").write_bytes(b"RIFFxxxx")
    with tarfile.open(payload, "w:bz2") as t:
        t.add(tmp_path / "stage" / "LJSpeech-1.1", arcname="LJSpeech-1.1")
    dest = pdl.extract(payload, tmp_path / "port" / "LJSpeech-1.1")
    want = jdl.extract(payload, tmp_path / "jax" / "LJSpeech-1.1")
    assert (dest / "wavs" / "LJ001-0001.wav").read_bytes() == b"RIFFxxxx"
    assert _files(dest) == _files(want)
    assert pdl.extract(payload, dest) == dest          # a second call skips


def test_extract_zip_with_nested_zips(tmp_path):
    archive = tmp_path / "VCTK-0.92.zip"
    _make_vctk_zip(archive)
    dest = pdl.extract(archive, tmp_path / "port" / "VCTK-0.92")
    want = jdl.extract(archive, tmp_path / "jax" / "VCTK-0.92")
    assert len(list(dest.rglob("*_mic1.flac"))) == 4
    assert _files(dest) == _files(want)
    # a stale staging directory from an interrupted run is cleared first
    stale = tmp_path / "again" / "VCTK-0.92.extracting"
    stale.mkdir(parents=True)
    (stale / "junk").write_text("x")
    again = pdl.extract(archive, tmp_path / "again" / "VCTK-0.92")
    assert _files(again) == _files(want)
    with pytest.raises(ValueError, match="unsupported archive"):
        pdl.extract(tmp_path / "data.rar", tmp_path / "rar")


def test_download_localhost_and_skip(tmp_path):
    (tmp_path / "srv").mkdir()
    (tmp_path / "srv" / "a.bin").write_bytes(b"\x01\x02" * 1000)
    handler = partial(SimpleHTTPRequestHandler,
                      directory=str(tmp_path / "srv"))
    httpd = HTTPServer(("127.0.0.1", 0), handler)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        out = pdl.download(f"http://127.0.0.1:{port}/a.bin",
                           tmp_path / "got" / "a.bin", progress=False)
        assert out.read_bytes() == b"\x01\x02" * 1000
        assert not out.with_suffix(".bin.part").exists()
        # a file already there is kept, and nothing is fetched
        out.write_bytes(b"staged")
        pdl.download("http://127.0.0.1:1/unreachable", out, progress=False)
        assert out.read_bytes() == b"staged"
    finally:
        httpd.shutdown()


def test_download_failure_message(tmp_path):
    with pytest.raises(RuntimeError, match="place the archive at"):
        pdl.download("http://127.0.0.1:1/nope", tmp_path / "nope.bin",
                     progress=False)
    assert not (tmp_path / "nope.bin").exists()
    assert not (tmp_path / "nope.bin.part").exists()


def _wavs(dest):
    return {w.name: load_wav(w) for w in sorted((dest / "wavs").glob("*"))}


def test_vctk_fetch_flow_matches_jax(tmp_path):
    """Extraction, the mic1 flacs decoded and resampled to 22.05 kHz, named
    <speaker>_<textnum>.wav: names and samples equal to JAX's."""
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        _make_vctk_zip(tmp_path / side / pdl.DATASETS["VCTK"]["out_file"])
    got = _wavs(pdl.fetch_dataset("VCTK", tmp_path / "port",
                                  skip_download=True))
    want = _wavs(jdl.fetch_dataset("VCTK", tmp_path / "jax",
                                   skip_download=True))
    assert list(got) == list(want) == ["p225_001.wav", "p225_002.wav",
                                       "p226_001.wav", "p226_002.wav"]
    for name, (audio, sr) in got.items():
        assert sr == want[name][1] == 22050
        np.testing.assert_array_equal(audio, want[name][0])
    audio, sr = got["p225_001.wav"]
    assert abs(len(audio) - 4800 * 22050 / 48000) <= 1
    peak_hz = np.argmax(np.abs(np.fft.rfft(audio))) * sr / len(audio)
    assert abs(peak_hz - 220) < 5              # the tone survives


def test_vctk_to_wavs_skips_existing(tmp_path, capsys):
    (tmp_path / "wavs").mkdir()
    assert pdl.vctk_to_wavs(tmp_path, tmp_path / "wavs") == 0
    assert "already exists" in capsys.readouterr().out


def test_prep_download_skip_download(tmp_path, capsys):
    _make_vctk_zip(tmp_path / "VCTK-0.92.zip")
    prep.main(["download", "--dataset", "VCTK", "--root", str(tmp_path),
               "--skip-download"])
    assert "dataset ready at" in capsys.readouterr().out
    (tmp_path / "jax").mkdir()
    _make_vctk_zip(tmp_path / "jax" / "VCTK-0.92.zip")
    want = _wavs(jdl.fetch_dataset("VCTK", tmp_path / "jax",
                                   skip_download=True))
    got = _wavs(tmp_path / "VCTK-0.92")
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name][0], want[name][0])
