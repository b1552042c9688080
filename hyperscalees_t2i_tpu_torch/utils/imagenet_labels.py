"""ImageNet class names in index order, from a file on disk (port of
``hyperscalees_t2i_tpu/utils/imagenet_labels.py``).

The reference fetches the canonical ``imagenet_classes.txt`` on first use
and caches it at :data:`DEFAULT_LABELS_PATH`. The port never downloads: a
missing file raises the ``RuntimeError`` the reference raises after a failed
fetch (it names the path and ``--labels_path``), or ``FileNotFoundError``
with ``download_if_missing=False``, as the reference does. A file whose line
count is not 1000 is a hard error, as in the reference: reward prompts built
from a short or shifted list would silently misname classes.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

IMAGENET_LABELS_URL = "https://raw.githubusercontent.com/pytorch/hub/master/imagenet_classes.txt"
DEFAULT_LABELS_PATH = Path.home() / ".cache" / "hyperscalees_t2i" / "imagenet_classes.txt"

_CACHE: dict = {}  # resolved path → labels


def get_imagenet_labels(
    labels_path: Union[str, Path, None] = None,
    download_if_missing: bool = True,
    url: str = IMAGENET_LABELS_URL,
    use_cache: bool = True,
) -> List[str]:
    """The 1000 ImageNet class names of ``labels_path`` (default
    :data:`DEFAULT_LABELS_PATH`), one per non-empty line, kept in-process
    per resolved path when ``use_cache``."""
    path = (Path(labels_path) if labels_path else DEFAULT_LABELS_PATH).resolve()
    if use_cache and path in _CACHE:
        return _CACHE[path]
    if not path.exists():
        if not download_if_missing:
            raise FileNotFoundError(f"ImageNet labels file not found: {path}")
        raise RuntimeError(
            f"could not download ImageNet labels from {url} (this package never downloads); in an "
            f"offline environment fetch the file once elsewhere and pass --labels_path (or place it at {path})"
        )
    labels = [l.strip() for l in path.read_text(encoding="utf-8").splitlines() if l.strip()]
    if len(labels) != 1000:
        raise RuntimeError(f"expected 1000 ImageNet labels, got {len(labels)} from {path} — "
                           f"delete the file to re-download")
    if use_cache:
        _CACHE[path] = labels
    return labels


def imagenet_class_name(class_id: int, **kwargs) -> str:
    labels = get_imagenet_labels(**kwargs)
    if 0 <= class_id < len(labels):
        return labels[class_id]
    return f"class_{class_id}"
