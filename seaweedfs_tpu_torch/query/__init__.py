"""Query engine: S3-Select-lite scan/filter over JSON and CSV blobs (the
port's copy of seaweedfs_tpu/query/).

Reference: weed/query/json/query_json.go (gjson path filtering +
projections, consumed by the volume server's Query RPC,
volume_grpc_query.go). The reference leaves CSV input as a stub; we
support it.
"""

from .json_query import Query, get_path, query_json, query_json_lines
from .csv_query import query_csv_lines

__all__ = ["Query", "get_path", "query_json", "query_json_lines",
           "query_csv_lines"]
