"""Volume-server pieces of the port. The server class itself is not ported
yet; `volume_server.make_shard_reader` is the EC read path it will wire in."""
