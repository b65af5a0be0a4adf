"""Stage 4: extract imgur image URLs from comment bodies, download, resize.

Port of Pre-Processing/4-get_images.py. URL extraction, path assignment and
resizing are offline-pure; the HTTP fetch is pluggable (the reference uses
requests-futures with rate limiting, lines 21-36).

The PyTorch port's copy of the JAX package's ``data_prep/images.py``.
"""

from __future__ import annotations

import json
import os
import re
from io import BytesIO
from typing import Callable, Dict, Iterable, List, Optional, Tuple

IMAGE_PATTERN = re.compile(r"https?:\/\/(\S+?(?:jpe?g|png|gif|svg))")
MAX_SIZE = 256  # 4-get_images.py:122-132


def parse_images(body: str) -> List[str]:
    """4-get_images.py:148-153: find image URLs, force https."""
    return ["https://" + url for url in IMAGE_PATTERN.findall(body or "")]


def get_images(link_id: str, comment: dict) -> List[Tuple[str, str, List[str]]]:
    """Walk a tree annotating ``comment['images']`` with target paths and
    collecting (link_id, comment_id, urls) download jobs — only
    i.imgur.com URLs are kept (4-get_images.py:155-180)."""
    if "body" in comment["data"]:
        image_urls = parse_images(comment["data"]["body"])
    else:
        image_urls = []
        comment["data"]["body"] = "NA"
    if "url" in comment["data"]:
        image_urls += parse_images(comment["data"]["url"])
    image_urls = [x for x in image_urls if "i.imgur.com" in x]
    if image_urls:
        res = [(link_id, comment["id"], image_urls)]
        cid = comment["id"]
        comment["images"] = [
            f"images/{link_id}/{cid}-{i}.png" for i, _ in enumerate(res)
        ]
    else:
        res = []
        comment["images"] = []
    for child in comment["tree"]:
        res += get_images(link_id, child)
    return res


def resize_image(img) -> "Image":
    """LANCZOS resize so the larger side is 256 (4-get_images.py:121-132)."""
    from PIL import Image

    height = int(img.height * MAX_SIZE / img.width)
    if height > MAX_SIZE:
        width = int(MAX_SIZE * img.width / img.height)
        return img.resize((width, MAX_SIZE), Image.Resampling.LANCZOS)
    return img.resize((MAX_SIZE, height), Image.Resampling.LANCZOS)


def save_image_bytes(
    content: bytes,
    name: str,
    path: str,
    i: int,
    deleted_fingerprints: Optional[List] = None,
) -> Optional[str]:
    """Decode, skip deleted-image fingerprints, resize, save as png
    (hook_factory, 4-get_images.py:101-144)."""
    from PIL import Image

    img = Image.open(BytesIO(content))
    for fp in deleted_fingerprints or []:
        if list(img.getdata()) == list(fp):
            return None
    img = resize_image(img)
    for fp in deleted_fingerprints or []:
        if img.size == getattr(fp, "size", None) and list(img.getdata()) == list(fp):
            return None
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"{name}-{i}.png")
    img.save(out)
    return out


def annotate_and_fetch(
    in_json: str,
    out_json: str,
    image_root: str = ".",
    fetcher: Optional[Callable[[str], Optional[bytes]]] = None,
    deleted_fingerprints: Optional[List] = None,
) -> int:
    """Stage-4 entry point: annotate trees with image paths; download via
    ``fetcher(url) -> bytes | None`` when provided (offline runs annotate
    only). Writes ``pruned-with-images.json``; returns #download jobs."""
    n_jobs = 0
    with open(in_json) as f, open(out_json, "w") as out:
        for line in f:
            if not line.strip():
                continue
            tree = json.loads(line)
            link_id = tree["id"]
            jobs = get_images(link_id, tree)
            tree["images"] = tree.get("images", [])
            for lk, cid, urls in jobs:
                n_jobs += len(urls)
                if fetcher is not None:
                    for i, url in enumerate(urls):
                        content = fetcher(url)
                        if content:
                            save_image_bytes(
                                content,
                                cid,
                                os.path.join(image_root, "images", lk),
                                i,
                                deleted_fingerprints,
                            )
            out.write(json.dumps(tree) + "\n")
    return n_jobs


def requests_fetcher(rate_limit_s: float = 0.2) -> Callable[[str], Optional[bytes]]:
    """Rate-limited HTTP fetcher (requires network; the reference's
    requests-futures pool, 4-get_images.py:21-36)."""
    import time

    import requests

    last = [0.0]

    def fetch(url: str) -> Optional[bytes]:
        wait = rate_limit_s - (time.time() - last[0])
        if wait > 0:
            time.sleep(wait)
        last[0] = time.time()
        try:
            r = requests.get(url, timeout=20)
            return r.content if r.ok else None
        except Exception:
            return None

    return fetch
