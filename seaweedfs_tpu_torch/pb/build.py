"""Generate *_pb2.py from the .proto files (no grpcio-tools in the image;
plain protoc message codegen + hand-rolled generic gRPC registration in
utils/rpc.py). Run: python -m seaweedfs_tpu_torch.pb.build

The port's copy of seaweedfs_tpu/pb/build.py: it regenerates the port's
pb/ from the port's .proto files, which are byte-equal copies of the
reference's."""

from __future__ import annotations

import pathlib
import subprocess

PB_DIR = pathlib.Path(__file__).parent


def build() -> None:
    protos = sorted(PB_DIR.glob("*.proto"))
    subprocess.run(
        ["protoc", f"-I{PB_DIR}", f"--python_out={PB_DIR}",
         *[str(p) for p in protos]],
        check=True)
    print(f"generated {len(protos)} proto modules in {PB_DIR}")


if __name__ == "__main__":
    build()
