"""The kernels' build key: a library is rebuilt when its source, a shared
header (``csrc/*.cuh``) or the flags change, and reused otherwise."""

from vqa_attention_networks_tpu_torch.ops import _build


def test_library_key_covers_source_and_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    first = _build.library_path("k")
    assert _build.library_path("k") == first  # unchanged: reused
    (csrc / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text('#include "h.cuh"\n// v2\n')
    assert _build.library_path("k") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    assert _build.library_path("k") != first


def test_every_kernel_source_names_the_headers_it_includes():
    # a header a source includes must sit in csrc/, where the key reads it
    for src in _build.CSRC_DIR.glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert (_build.CSRC_DIR / line.split('"')[1]).exists(), src
