"""S3 pieces of the port. Only the client-side sigv4 signer is here, for the
S3-family remote tiers of storage/backend.py; the gateway is not ported
yet."""
