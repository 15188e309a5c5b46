"""Checkpoint downloads: mirrors tried in order, sha256 verified.

Restated from ``depthmap_tpu/utils/download.py`` (the port imports nothing
of the JAX package; tests/test_torch_port_utils.py holds the tables equal
to the originals): the URL / sha256 tables ``CHECKPOINT_URLS``,
``PIX2PIX_URL``, ``MARIGOLD_URLS`` and ``INPAINT_URLS``, the
trust-on-first-use pins and the ``ensure_*`` functions.  Nothing calls
them unless ``DEPTHMAP_ALLOW_DOWNLOAD=1``: then a missing depth checkpoint
(``pipeline/depth.py``), Marigold's diffusers tree and Boost's pix2pix
weights (``pipeline/core.py _load_pix2pix``) are fetched into the weights
directory.  Every checkpoint is read with ``torch.load(weights_only=True)``
(``models/weights.py``).  A failure falls through to the next mirror and
finally raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.request
from typing import List, Optional, Union

CHECKPOINT_URLS = {
    # model id -> (filename, [mirrors], sha256 prefix or None)
    #
    # sha256 provenance: res101 + the inpaint nets carry the full hashes the
    # reference records (depthmap_generation.py:110, core.py:375-390); the
    # torch-hub-style filenames (`-<8 hex>` suffix) embed the first 8 sha256
    # chars by torch.hub convention and are used as prefixes.  Entries that
    # remain None have no hash recorded anywhere in the reference; they are
    # pinned trust-on-first-use instead (see the pinning section below), and the
    # pickle-RCE risk of an unverified FIRST fetch is closed by loading
    # every checkpoint with torch.load(weights_only=True)
    # (models/weights.py).
    0: ("res101.pth",
        ["https://huggingface.co/lllyasviel/Annotators/resolve/5bc80eec2b4fddbb/res101.pth",
         "https://cloudstor.aarnet.edu.au/plus/s/lTIJF4vrvHCAI31/download"],
        "1d696b2ef3e8336b057d0c15bc82d2fecef821bfebe5ef9d7671a5ec5dde520b"),
    1: ("dpt_beit_large_512.pt",
        ["https://github.com/isl-org/MiDaS/releases/download/v3_1/dpt_beit_large_512.pt"],
        None),
    2: ("dpt_beit_large_384.pt",
        ["https://github.com/isl-org/MiDaS/releases/download/v3_1/dpt_beit_large_384.pt"],
        None),
    3: ("dpt_large-midas-2f21e586.pt",
        ["https://github.com/intel-isl/DPT/releases/download/1_0/dpt_large-midas-2f21e586.pt"],
        "2f21e586"),
    4: ("dpt_hybrid-midas-501f0c75.pt",
        ["https://github.com/intel-isl/DPT/releases/download/1_0/dpt_hybrid-midas-501f0c75.pt"],
        "501f0c75"),
    5: ("midas_v21-f6b98070.pt",
        ["https://github.com/AlexeyAB/MiDaS/releases/download/midas_dpt/midas_v21-f6b98070.pt"],
        "f6b98070"),
    6: ("midas_v21_small-70d6b9c8.pt",
        ["https://github.com/AlexeyAB/MiDaS/releases/download/midas_dpt/midas_v21_small-70d6b9c8.pt"],
        "70d6b9c8"),
    7: ("ZoeD_M12_N.pt",
        ["https://github.com/isl-org/ZoeDepth/releases/download/v1.0/ZoeD_M12_N.pt"],
        None),
    8: ("ZoeD_M12_K.pt",
        ["https://github.com/isl-org/ZoeDepth/releases/download/v1.0/ZoeD_M12_K.pt"],
        None),
    9: ("ZoeD_M12_NK.pt",
        ["https://github.com/isl-org/ZoeDepth/releases/download/v1.0/ZoeD_M12_NK.pt"],
        None),
    11: ("depth_anything_vitl14.pth",
         ["https://huggingface.co/spaces/LiheYoung/Depth-Anything/resolve/main/checkpoints/depth_anything_vitl14.pth"],
         None),
    12: ("depth_anything_v2_vits.pth",
         ["https://huggingface.co/depth-anything/Depth-Anything-V2-Small/resolve/main/depth_anything_v2_vits.pth"],
         None),
    13: ("depth_anything_v2_vitb.pth",
         ["https://huggingface.co/depth-anything/Depth-Anything-V2-Base/resolve/main/depth_anything_v2_vitb.pth"],
         None),
    14: ("depth_anything_v2_vitl.pth",
         ["https://huggingface.co/depth-anything/Depth-Anything-V2-Large/resolve/main/depth_anything_v2_vitl.pth"],
         None),
}

# Boost merge network (reference depthmap_generation.py:288-301; downloaded
# into ./models/pix2pix/ whenever Boost is enabled).
PIX2PIX_URL = (
    "pix2pix/latest_net_G.pth",
    ["https://huggingface.co/lllyasviel/Annotators/resolve/9a7d84251d487d11/latest_net_G.pth",
     "https://sfu.ca/~yagiz/CVPR21/latest_net_G.pth"],
    "50ec735d74ed6499562d898f41b49343e521808b8dae589aa3c2f5c9ac9f7462")

# Marigold (reference loads the diffusers repo "Bingxin/Marigold",
# depthmap_generation.py:215-221).  Fetched per-component into
# <weights_dir>/marigold/{unet,vae,text_encoder,tokenizer}/ in the layout
# models/weights.py load_marigold_checkpoint expects.
MARIGOLD_URLS = {
    "unet/diffusion_pytorch_model.bin":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/unet/diffusion_pytorch_model.bin"],
    "unet/config.json":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/unet/config.json"],
    "vae/diffusion_pytorch_model.bin":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/vae/diffusion_pytorch_model.bin"],
    "vae/config.json":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/vae/config.json"],
    "text_encoder/pytorch_model.bin":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/text_encoder/pytorch_model.bin"],
    "text_encoder/config.json":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/text_encoder/config.json"],
    "tokenizer/vocab.json":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/tokenizer/vocab.json"],
    "tokenizer/merges.txt":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/tokenizer/merges.txt"],
    "tokenizer/tokenizer_config.json":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/tokenizer/tokenizer_config.json"],
    "tokenizer/special_tokens_map.json":
        ["https://huggingface.co/Bingxin/Marigold/resolve/main/tokenizer/special_tokens_map.json"],
}

INPAINT_URLS = {
    "edge": ("edge_model.pth",
             ["https://huggingface.co/spaces/Epoching/3D_Photo_Inpainting/resolve/e389e564fd2a55cf/checkpoints/edge-model.pth",
              "https://filebox.ece.vt.edu/~jbhuang/project/3DPhoto/model/edge-model.pth"],
             "b1d768bd008ad5fe9f540004f870b8c3d355e4939b2009aa4db493fd313217c9"),
    "depth": ("depth_model.pth",
              ["https://huggingface.co/spaces/Epoching/3D_Photo_Inpainting/resolve/e389e564fd2a55cf/checkpoints/depth-model.pth",
               "https://filebox.ece.vt.edu/~jbhuang/project/3DPhoto/model/depth-model.pth"],
              "2d0e63e89a22762ddfa8bc8c9f8c992e5532b140123274ffc6e4171baa1b76f8"),
    "color": ("color_model.pth",
              ["https://huggingface.co/spaces/Epoching/3D_Photo_Inpainting/resolve/e389e564fd2a55cf/checkpoints/color-model.pth",
               "https://filebox.ece.vt.edu/~jbhuang/project/3DPhoto/model/color-model.pth"],
              "383c9b1db70097907a6f9c8abb0303e7056f50d5456a36f34ab784592b8b2c20"),
}


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sha256_prefix_ok(path: str, prefix: Optional[str]) -> bool:
    if not prefix:
        return True
    return _sha256_file(path).startswith(prefix)


# -- trust-on-first-use hash pinning ----------------------------------------
# For the 13 registry entries with no hash recorded anywhere (reference
# records none either), the first successful download pins the file's FULL
# sha256 to a `.sha256_pins.json` sidecar next to it; every later download
# or local-file reuse of that name verifies against the pin.  A compromised
# mirror can therefore only poison a *fresh* deployment's first fetch — and
# that window, plus explicitly-pinned prefixes, is closed by
# torch.load(weights_only=True) on every checkpoint (models/weights.py).

PIN_FILENAME = ".sha256_pins.json"


def _pin_store_path(filename: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(filename)),
                        PIN_FILENAME)


def _read_pin(filename: str) -> Optional[str]:
    import json
    try:
        with open(_pin_store_path(filename)) as f:
            return json.load(f).get(os.path.basename(filename))
    except (OSError, ValueError):
        return None


def _write_pin(filename: str, digest: str) -> None:
    import json
    store = _pin_store_path(filename)
    data = {}
    try:
        with open(store) as f:
            data = json.load(f)
    except (OSError, ValueError):
        pass
    data[os.path.basename(filename)] = digest
    tmp = store + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, store)


def _expected_hash(filename: str,
                   explicit_prefix: Optional[str]) -> Optional[str]:
    """Explicit registry prefix wins; otherwise any recorded pin."""
    return explicit_prefix or _read_pin(filename)


def ensure_file_downloaded(filename: str,
                           url: Union[str, List[str]],
                           sha256_hash_prefix: Optional[str] = None) -> str:
    """Parity with reference misc.py:27-44 (try mirrors in order, verify the
    sha256 prefix, keep the first good file) + trust-on-first-use pinning
    for entries with no recorded hash."""
    expected = _expected_hash(filename, sha256_hash_prefix)
    if os.path.exists(filename):
        digest = _sha256_file(filename)
        if not expected or digest.startswith(expected):
            if _read_pin(filename) is None:
                _write_pin(filename, digest)
            return filename
        if sha256_hash_prefix is None and _read_pin(filename) is not None:
            raise RuntimeError(
                f"{filename!r} does not match its pinned sha256 (see "
                f"{_pin_store_path(filename)}); delete the pin entry if the "
                "file was updated intentionally")
    urls = [url] if isinstance(url, str) else list(url)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    last_err: Optional[Exception] = None
    for u in urls:
        tmp_name = None
        try:
            with tempfile.NamedTemporaryFile(delete=False) as tmp:
                tmp_name = tmp.name
                with urllib.request.urlopen(u, timeout=60) as r:
                    shutil.copyfileobj(r, tmp)
            digest = _sha256_file(tmp_name)
            if not expected or digest.startswith(expected):
                shutil.move(tmp_name, filename)
                _write_pin(filename, digest)
                return filename
            last_err = ValueError(f"sha256 mismatch for {u}")
        except Exception as e:  # network failure -> next mirror
            last_err = e
        # never leave a partial multi-GB temp file behind per failed mirror
        if tmp_name is not None and os.path.exists(tmp_name):
            try:
                os.unlink(tmp_name)
            except OSError:
                pass
    raise RuntimeError(
        f"Could not download {filename!r} from any mirror "
        f"({len(urls)} tried); last error: {last_err}")


def ensure_model_downloaded(model_type: int,
                            weights_dir: str = "./models") -> str:
    if model_type == 10:
        return ensure_marigold_downloaded(weights_dir)
    fn, mirrors, sha = CHECKPOINT_URLS[model_type]
    return ensure_file_downloaded(os.path.join(weights_dir, fn), mirrors, sha)


def ensure_pix2pix_downloaded(weights_dir: str = "./models") -> str:
    """Boost merge-net checkpoint (reference depthmap_generation.py:288-301)."""
    fn, mirrors, sha = PIX2PIX_URL
    return ensure_file_downloaded(os.path.join(weights_dir, fn), mirrors, sha)


def ensure_marigold_downloaded(weights_dir: str = "./models") -> str:
    """All Marigold components -> <weights_dir>/marigold/; returns that dir."""
    root = os.path.join(weights_dir, "marigold")
    for rel, mirrors in MARIGOLD_URLS.items():
        ensure_file_downloaded(os.path.join(root, rel), mirrors, None)
    return root
