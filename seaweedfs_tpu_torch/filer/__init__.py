"""Filer: POSIX-ish namespace over the blob store.

Reference layer L5 (weed/filer, 16,511 LoC — SURVEY.md §2.5): entry CRUD on
pluggable metadata stores, chunked-file model with newest-wins interval
resolution and manifest chunks, metadata event log with subscription, HTTP
and gRPC APIs."""

from .chunks import ChunkView, read_views, resolve_chunks, total_size
from .filer import Filer, join_path, split_path
from .filer_server import FilerServer
from .store import (FilerStore, LogDbStore, LsmStore, MemoryStore,
                    SqliteStore, open_store)

__all__ = [
    "ChunkView", "Filer", "FilerServer", "FilerStore", "LogDbStore", "LsmStore",
    "MemoryStore", "SqliteStore", "join_path", "open_store", "read_views",
    "resolve_chunks", "split_path", "total_size",
]
