"""Resize/crop/orientation for the read handler.

Reference semantics (weed/images/resizing.go:18 Resized):
- width==0 and height==0 -> unchanged
- source smaller than requested box -> unchanged (no upscaling)
- mode "fit": keep aspect, fit inside width x height
- mode "fill": keep aspect, cover width x height, center-crop
- default: square request on a non-square image -> thumbnail (fill);
  otherwise plain resize to the given dims (0 keeps aspect)
Supported extensions match shouldResizeImages
(volume_server_handlers_read.go:333): png/jpg/jpeg/gif/webp.
"""

from __future__ import annotations

import io

try:
    from PIL import Image, ImageOps
    HAVE_PIL = True
except Exception:  # pragma: no cover - PIL is in the image
    HAVE_PIL = False

RESIZABLE_EXTS = (".png", ".jpg", ".jpeg", ".gif", ".webp")

_PIL_FORMAT = {".png": "PNG", ".jpg": "JPEG", ".jpeg": "JPEG",
               ".gif": "GIF", ".webp": "WEBP"}


def should_resize(ext: str, query: dict) -> tuple[int, int, str, bool]:
    """(width, height, mode, should) from request params
    (reference shouldResizeImages volume_server_handlers_read.go:333)."""
    ext = ext.lower()
    if ext not in RESIZABLE_EXTS:
        return 0, 0, "", False
    try:
        width = int(query.get("width", 0) or 0)
        height = int(query.get("height", 0) or 0)
    except ValueError:
        return 0, 0, "", False
    mode = query.get("mode", "")
    return width, height, mode, (width > 0 or height > 0)


def resized(ext: str, data: bytes, width: int, height: int,
            mode: str = "") -> bytes:
    if not HAVE_PIL or (width == 0 and height == 0):
        return data
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return data
    w, h = img.size
    # no upscaling (resizing.go:26: only act when source exceeds the box)
    if not ((w > width and width != 0) or (h > height and height != 0)):
        return data
    if mode == "fit":
        out = ImageOps.contain(img, (width or w, height or h))
    elif mode == "fill":
        out = ImageOps.fit(img, (width or w, height or h))
    elif width == height and width != 0 and w != h:
        out = ImageOps.fit(img, (width, height))  # thumbnail
    else:
        if width == 0:
            width = max(1, w * height // h)
        if height == 0:
            height = max(1, h * width // w)
        out = img.resize((width, height))
    buf = io.BytesIO()
    fmt = _PIL_FORMAT.get(ext.lower(), img.format or "PNG")
    if fmt == "JPEG" and out.mode not in ("RGB", "L"):
        out = out.convert("RGB")
    out.save(buf, format=fmt)
    return buf.getvalue()


def fix_jpeg_orientation(data: bytes) -> bytes:
    """Bake EXIF orientation into pixels (reference images/orientation.go,
    applied on read in the needle path for jpeg with orientation tag)."""
    if not HAVE_PIL:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        orientation = img.getexif().get(0x0112, 1)  # EXIF Orientation tag
        if orientation == 1:
            return data
        fixed = ImageOps.exif_transpose(img)
        if fixed is None:
            return data
        buf = io.BytesIO()
        fixed.save(buf, format="JPEG")
        return buf.getvalue()
    except Exception:
        return data
