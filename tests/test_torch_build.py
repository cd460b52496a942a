"""What the kernels' build relies on, checked without a GPU: the library's
hash covers every source and header of ``csrc/``, so an edited header is
rebuilt, and every header a source includes is in ``csrc/``, beside it,
where ``nvcc`` looks first (the card's machine has nothing else)."""

from __future__ import annotations

import re
import shutil

import pytest

from parler_tts_tpu_torch.ops import cuda_build

SOURCES = sorted(p.name for p in cuda_build.CSRC.glob("*.cu*"))
LIBRARIES = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    return copy


def test_csrc_holds_the_sources_and_their_header():
    assert {"flash_attention_fwd.cu", "flash_attention_bwd.cu", "sm90_mma.cuh"} <= set(SOURCES)


@pytest.mark.parametrize("library", LIBRARIES)
def test_a_copy_of_csrc_hashes_as_the_original(csrc, library):
    assert cuda_build._library_path(library, csrc) == cuda_build._library_path(library)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("library", LIBRARIES)
def test_the_build_hash_changes_with_any_file_of_csrc(csrc, source, library):
    before = cuda_build._library_path(library, csrc)
    (csrc / source).write_text((csrc / source).read_text() + "\n// edited\n")
    assert cuda_build._library_path(library, csrc) != before


@pytest.mark.parametrize("source", SOURCES)
def test_every_quoted_include_resolves_in_csrc(source):
    text = (cuda_build.CSRC / source).read_text()
    for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
        assert (cuda_build.CSRC / name).is_file(), f"{source} includes {name}, which is not in csrc/"


def test_both_sources_include_the_shared_header():
    for library in ("flash_attention_fwd", "flash_attention_bwd"):
        assert '#include "sm90_mma.cuh"' in (cuda_build.CSRC / f"{library}.cu").read_text()
