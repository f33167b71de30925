"""Image ops applied on the volume read path (reference weed/images).

`resized` mirrors images/resizing.go:18 (fit/fill/thumbnail/plain modes,
no-op when the source is already small enough); `fix_jpeg_orientation`
mirrors orientation.go (bake the EXIF orientation tag into the pixels).
PIL-backed; when PIL is unavailable the ops become identity functions.

The port's copy of seaweedfs_tpu/images/: the resize runs on the host, as
the reference's does; the volume server applies it to the needle bytes it
assembled, after a degraded EC read's reconstruct on the card.
"""

from .resize import fix_jpeg_orientation, resized, should_resize

__all__ = ["resized", "should_resize", "fix_jpeg_orientation"]
