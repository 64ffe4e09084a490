"""CLIP weight resolution: the counterpart of
anomalyclip_tpu/models/clip/registry.py, giving the port's tree (fp32 tensors
on the CPU) and its config.

Replaces the reference's download-on-demand ``clip.load`` (reference:
src/models/components/clip/clip.py:31-81, 108-163). Weights resolve from local
files first, then from the SHA256-pinned OpenAI release URLs:

    1. explicit ``clip_ckpt_path`` config / CLIP_CKPT_PATH env var
    2. ~/.cache/clip/<arch>.pt (the reference's own cache location)
    3. download from ``_MODELS`` with SHA256 verification (clip.py:31-81),
       skipped under ANOMALYCLIP_NO_DOWNLOAD
    4. ``clip_init: random`` -> randomly initialized params (the tiny config),
       ``random-full`` -> the arch's config at full size: tests and benchmarks.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Tuple

import torch

from anomalyclip_tpu_torch.models.clip.convert import load_torch_clip_checkpoint
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, Params, init_clip_params


_ARCH_CONFIGS = {
    "ViT-B/16": CLIPConfig.vit_b16,
    "ViT-B/32": CLIPConfig.vit_b32,
    "ViT-L/14": CLIPConfig.vit_l14,
    "ViT-L/14@336px": CLIPConfig.vit_l14_336,
    "RN50": CLIPConfig.rn50,
}

_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def sha256_file(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _checkpoint_filename(arch: str) -> str:
    """Cache filename for ``arch`` — the release URL's basename when one is
    pinned, so files live exactly where the reference's clip.load puts them
    (clip.py:91: basename of the URL; e.g. ViT-L/14@336px -> ViT-L-14-336px.pt,
    NOT ViT-L-14@336px.pt)."""
    if arch in _MODELS:
        return _MODELS[arch].split("/")[-1]
    return arch.replace("/", "-") + ".pt"


def download_clip(arch: str, root: Optional[Path] = None, timeout: int = 60) -> Path:
    """Download ``arch``'s OpenAI checkpoint into the reference's cache location
    with SHA256 verification (clip.py:83-105's contract via stdlib urllib).
    Raises on unknown arch, network failure (e.g. a zero-egress host), or a
    hash mismatch (the corrupt file is removed)."""
    import urllib.request

    if arch not in _MODELS:
        raise KeyError(f"no download URL for {arch!r}; known: {sorted(_MODELS)}")
    url = _MODELS[arch]
    expected = url.split("/")[-2]
    root = root or (Path.home() / ".cache" / "clip")
    root.mkdir(parents=True, exist_ok=True)
    target = root / _checkpoint_filename(arch)
    if target.is_file() and sha256_file(target) == expected:
        return target
    # per-process temp name: concurrent callers (multi-host module init,
    # parallel sweep trials sharing $HOME) must not interleave writes into one
    # shared .partial — each downloads privately, the atomic replace wins-last
    tmp = target.with_suffix(f".pt.partial.{os.getpid()}")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, open(tmp, "wb") as out:
            while True:
                block = resp.read(1 << 20)
                if not block:
                    break
                out.write(block)
        if sha256_file(tmp) != expected:
            raise RuntimeError(f"SHA256 mismatch downloading {arch} from {url}")
        tmp.replace(target)
    finally:
        tmp.unlink(missing_ok=True)  # no-op after the successful replace
    return target


def available_models() -> list:
    """Architectures with a named config (the reference's clip.available_models,
    clip.py:103-105; any other OpenAI arch still loads via checkpoint shape
    inference in convert.config_from_state_dict)."""
    return sorted(_ARCH_CONFIGS)


def _cache_candidates(arch: str) -> list:
    # URL-basename first (the reference's clip.load layout), then the literal
    # arch name as a legacy spelling (earlier builds wrote e.g. ViT-L-14@336px.pt)
    names = list(dict.fromkeys([_checkpoint_filename(arch), arch.replace("/", "-") + ".pt"]))
    roots = [Path.home() / ".cache" / "clip", Path("/usr/src/app/.cache/clip")]
    return [root / n for root in roots for n in names]


def resolve_clip(
    arch: str = "ViT-B/16",
    clip_init: str = "pretrained",
    clip_ckpt_path: Optional[str] = None,
    seed: int = 0,
) -> Tuple[Params, CLIPConfig]:
    """-> (the port's CLIP tree on the CPU, CLIPConfig). ``random`` and
    ``random-full`` draw from ``init_clip_params`` with a generator seeded from
    ``seed``: the distributions of the JAX package's init, not its numbers."""
    if clip_init == "random":
        cfg = CLIPConfig.tiny()
        return init_clip_params(torch.Generator().manual_seed(seed), cfg), cfg
    if clip_init == "random-full":
        cfg = _ARCH_CONFIGS.get(arch, CLIPConfig.vit_b16)()
        return init_clip_params(torch.Generator().manual_seed(seed), cfg), cfg

    candidates = []
    if clip_ckpt_path:
        candidates.append(Path(clip_ckpt_path))
    env = os.environ.get("CLIP_CKPT_PATH")
    if env:
        candidates.append(Path(env))
    candidates.extend(_cache_candidates(arch))
    for path in candidates:
        if path.is_file():
            return load_torch_clip_checkpoint(path)

    # Step 3: self-bootstrap from the SHA256-pinned release URL — the
    # reference's download-on-demand behavior (clip.py:108-130). Opt out with
    # ANOMALYCLIP_NO_DOWNLOAD=1 (air-gapped hosts where the DNS/socket timeout
    # is worth skipping); a zero-egress host fails fast and falls through to
    # the FileNotFoundError below with the download error attached.
    download_err = None
    if arch in _MODELS and not os.environ.get("ANOMALYCLIP_NO_DOWNLOAD"):
        try:
            return load_torch_clip_checkpoint(download_clip(arch))
        except Exception as e:  # noqa: BLE001 — no egress / proxy / disk errors
            download_err = e
    raise FileNotFoundError(
        f"No CLIP checkpoint found for {arch}. Provide model.net.clip_ckpt_path or "
        f"set CLIP_CKPT_PATH, or use model.net.clip_init=random-full for random "
        f"weights. Searched: {[str(c) for c in candidates]}"
        + (f"; download attempt failed: {type(download_err).__name__}: {download_err}"
           if download_err is not None else "")
    )
