"""gRPC without grpcio-tools: generic method registration + client stubs
(the port's copy of the JAX package's utils/rpc.py).

Services are declared in code against the protoc-generated message classes
of `pb/`. The server side builds a GenericRpcHandler per service; the
client side wraps channel.unary_unary etc. with cached channels. The
service strings are the JAX package's, so its stubs reach the port's
servers and the other way round.

The cluster key: a process given the signing key (`set_cluster_key`)
attaches a bearer token to every Stub call, and a server started with
`serve(..., auth_key=...)` checks it before dispatch, so a port server joins
a JAX-package cluster started with -jwtSigningKey. mTLS: one process-wide
`TlsConfig` (`set_tls_config`, or `load_tls_from_security_toml` for the
`[grpc]` section of security.toml) makes every `serve` bind a secure port
and every channel dial one, both sides presenting the cluster certificate.
The QoS class of the calling flow rides every call as `x-swtpu-qos`
metadata, and a served handler runs under the class it carries. This module
and `pb/` are the only ones of the port, with `server/grpc_service.py`, that
import `grpc` or `google.protobuf`; the volume server's core never does.
"""

from __future__ import annotations

import threading
from typing import Callable

import grpc

from ..profiling.lag import MonitoredPool

# -- optional gRPC auth ------------------------------------------------------
# The reference gates its gRPC plane with mTLS from security.toml
# (weed/security/tls.go:26,92). Our equivalent is a shared-key bearer token:
# when a process is configured with the cluster signing key
# (set_cluster_key), every outgoing Stub call attaches a JWT and every
# serve(..., auth_key=...) server verifies it before dispatch. Empty key =
# open cluster, matching the reference default.

_cluster_key: str = ""
_cluster_key_lock = threading.Lock()

# -- optional mTLS -----------------------------------------------------------
# The reference's security.toml [grpc] section configures per-component
# ca/cert/key (weed/security/tls.go:26 NewServerTLS, :92 NewClientTLS);
# here one process-wide TlsConfig covers every serve() and Stub channel.
# Both peers verify each other (require_client_auth) — configure it with
# set_tls_config() before starting servers/clients. None = plaintext.


class TlsConfig:
    def __init__(self, ca_path: str, cert_path: str, key_path: str,
                 server_name: str = "swtpu"):
        self.server_name = server_name
        with open(ca_path, "rb") as f:
            self.ca = f.read()
        with open(cert_path, "rb") as f:
            self.cert = f.read()
        with open(key_path, "rb") as f:
            self.key = f.read()

    def server_credentials(self):
        return grpc.ssl_server_credentials(
            [(self.key, self.cert)], root_certificates=self.ca,
            require_client_auth=True)

    def channel_credentials(self):
        return grpc.ssl_channel_credentials(
            root_certificates=self.ca, private_key=self.key,
            certificate_chain=self.cert)


_tls_config: "TlsConfig | None" = None


def set_tls_config(tls: "TlsConfig | None") -> None:
    """Install process-wide mTLS; drops cached plaintext channels so new
    stubs dial securely."""
    global _tls_config
    with _channel_lock:
        _tls_config = tls
        for ch in _channel_cache.values():
            ch.close()
        _channel_cache.clear()


def load_tls_from_security_toml() -> "TlsConfig | None":
    """[grpc] ca / cert / key on the config tier chain (tls.go analogue).
    A PARTIAL [grpc] section raises rather than silently running plaintext
    (fail closed — the operator clearly intended TLS)."""
    from . import config as cfg
    sec = cfg.load_config("security")
    ca = cfg.get_dotted(sec, "grpc.ca", "")
    cert = cfg.get_dotted(sec, "grpc.cert", "")
    key = cfg.get_dotted(sec, "grpc.key", "")
    name = cfg.get_dotted(sec, "grpc.server_name", "swtpu")
    if not (ca or cert or key):
        return None
    if not (ca and cert and key):
        raise ValueError("security.toml [grpc] must set all of ca/cert/key "
                         "(or none)")
    return TlsConfig(ca, cert, key, server_name=name)


def set_cluster_key(key: str) -> None:
    """Accepts the configured signing key; stores the DERIVED gRPC-plane
    key so control-plane bearer tokens never double as data-plane JWTs."""
    from ..security.jwt import derive_cluster_key
    global _cluster_key
    with _cluster_key_lock:
        _cluster_key = derive_cluster_key(key)


def _outgoing_metadata() -> list[tuple[str, str]]:
    md = []
    # trace-context propagation: a sampled active span rides every gRPC
    # hop as traceparent metadata; unsampled/absent adds nothing
    from .. import tracing
    tp = tracing.injectable()
    if tp:
        md.append((tracing.TRACEPARENT_HEADER, tp))
    # QoS class tag: maintenance-tagged flows (rebuild readers, volume
    # copies) stay maintenance-class across every gRPC hop so remote
    # survivor reads and file pulls yield to foreground work there
    from .. import qos
    qc = qos.injectable()
    if qc:
        md.append((qos.QOS_HEADER, qc))
    if not _cluster_key:
        return md
    from ..security.jwt import gen_jwt_for_filer_server
    md.append(("authorization", "Bearer "
               + gen_jwt_for_filer_server(_cluster_key, 60)))
    return md


class _AuthInterceptor(grpc.ServerInterceptor):
    def __init__(self, key: str):
        self._key = key

    def intercept_service(self, continuation, handler_call_details):
        from ..security.jwt import JwtError, decode_jwt
        for k, v in handler_call_details.invocation_metadata or ():
            if k == "authorization" and v.startswith("Bearer "):
                try:
                    decode_jwt(v[7:], self._key)
                    return continuation(handler_call_details)
                except JwtError:
                    break
        # Reject with a handler of the same streaming shape as the target
        # method, else grpc mismatches the wire protocol.
        handler = continuation(handler_call_details)
        if handler is None:
            return None

        def abort(request_or_iter, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or invalid cluster token")

        def abort_stream(request_or_iter, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or invalid cluster token")
            yield  # pragma: no cover

        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                abort, handler.request_deserializer,
                handler.response_serializer)
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                abort_stream, handler.request_deserializer,
                handler.response_serializer)
        if handler.stream_unary:
            return grpc.stream_unary_rpc_method_handler(
                abort, handler.request_deserializer,
                handler.response_serializer)
        return grpc.stream_stream_rpc_method_handler(
            abort_stream, handler.request_deserializer,
            handler.response_serializer)


def _extract_trace_context(context):
    """Inbound traceparent metadata -> SpanContext | None."""
    from .. import tracing
    try:
        for k, v in context.invocation_metadata() or ():
            if k == tracing.TRACEPARENT_HEADER:
                return tracing.parse_traceparent(v)
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (tracing must never break dispatch)
        pass
    return None


def _extract_qos_class(context) -> str:
    """Inbound x-swtpu-qos metadata -> class name ('' = untagged)."""
    from .. import qos
    try:
        for k, v in context.invocation_metadata() or ():
            if k == qos.QOS_HEADER and v in qos.CLASSES:
                return v
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (qos tagging must never break dispatch)
        pass
    return ""


def _component_of(service: str) -> str:
    # "swtpu.master.Master" -> "master"
    parts = service.split(".")
    return parts[1] if len(parts) > 1 else service


# Server-streaming methods that are subscriptions, not requests: the
# stream lives as long as its subscriber, so a span around it would be a
# root of giant duration on every routine disconnect.
_LONG_LIVED_STREAMS = frozenset({
    "SubscribeMetadata", "SubscribeLocalMetadata", "VolumeTailSender"})


class RpcService:
    """Declarative service: register handlers, then mount on a grpc.Server.

    Unary and bounded server-streaming handlers run inside a tracing span
    (`rpc/<Method>`) parented on the caller's traceparent metadata, and
    under the QoS class of the caller's `x-swtpu-qos` metadata;
    bidirectional streams (heartbeats) and the subscriptions of
    _LONG_LIVED_STREAMS are not spanned."""

    def __init__(self, name: str):
        self.name = name  # e.g. "swtpu.volume.VolumeServer"
        self._handlers: dict[str, grpc.RpcMethodHandler] = {}
        self._component = _component_of(name)

    def _traced_unary(self, method: str, fn: Callable) -> Callable:
        from .. import tracing
        comp = self._component

        def wrapped(request, context):
            from .. import qos as qos_mod
            qc = _extract_qos_class(context)
            token = qos_mod.set_class(qc) if qc else None
            try:
                with tracing.start_span(
                        f"rpc/{method}", component=comp,
                        child_of=_extract_trace_context(context)) as sp:
                    try:
                        return fn(request, context)
                    except Exception as e:  # noqa: BLE001 — incl. grpc aborts
                        sp.set_error(e)
                        raise
            finally:
                if token is not None:
                    qos_mod.reset_class(token)
        return wrapped

    def _traced_stream(self, method: str, fn: Callable) -> Callable:
        from .. import tracing
        comp = self._component

        def wrapped(request, context):
            from .. import qos as qos_mod
            qc = _extract_qos_class(context)
            token = qos_mod.set_class(qc) if qc else None
            try:
                with tracing.start_span(
                        f"rpc/{method}", component=comp,
                        child_of=_extract_trace_context(context)) as sp:
                    try:
                        yield from fn(request, context)
                    except GeneratorExit:
                        # client cancelled / stopped consuming: routine
                        # teardown, not a stream failure
                        sp.status = "cancelled"
                        raise
                    except Exception as e:  # noqa: BLE001
                        sp.set_error(e)
                        raise
            finally:
                if token is not None:
                    qos_mod.reset_class(token)
        return wrapped

    def unary(self, method: str, req_cls, resp_cls):
        def deco(fn: Callable):
            self._handlers[method] = grpc.unary_unary_rpc_method_handler(
                self._traced_unary(method, fn),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
            return fn
        return deco

    def unary_stream(self, method: str, req_cls, resp_cls):
        def deco(fn: Callable):
            handler = (fn if method in _LONG_LIVED_STREAMS
                       else self._traced_stream(method, fn))
            self._handlers[method] = grpc.unary_stream_rpc_method_handler(
                handler,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
            return fn
        return deco

    def stream_stream(self, method: str, req_cls, resp_cls):
        def deco(fn: Callable):
            self._handlers[method] = grpc.stream_stream_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
            return fn
        return deco

    def generic_handler(self) -> grpc.GenericRpcHandler:
        return grpc.method_handlers_generic_handler(self.name, self._handlers)


def serve(bind: str, services: list[RpcService], max_workers: int = 16,
          auth_key: str = "") -> grpc.Server:
    """Serve `services` on `bind`; with `auth_key` (the signing key) every
    call must carry a cluster token derived from it; under a TlsConfig the
    port is secure and every caller must present a certificate of the
    cluster's CA."""
    from ..security.jwt import derive_cluster_key
    port = int(bind.rsplit(":", 1)[1])
    if not 0 < port < 65536:
        # grpc silently wraps port numbers modulo 65536, so an overflowed
        # "+10000 convention" port would bind somewhere surprising and
        # clients would talk to the wrong server — fail loudly instead
        raise ValueError(f"invalid port in bind address {bind!r}")
    # queue-accounted: a call's wait for a worker is
    # SeaweedFS_pool_queue_wait_seconds{pool="grpc"}, which no handler's
    # own timer sees
    server = grpc.server(
        MonitoredPool("grpc", max_workers=max_workers,
                      thread_name_prefix="grpc-worker"),
        interceptors=([_AuthInterceptor(derive_cluster_key(auth_key))]
                      if auth_key else []),
        options=[("grpc.max_receive_message_length", 256 << 20),
                 ("grpc.max_send_message_length", 256 << 20)])
    for s in services:
        server.add_generic_rpc_handlers((s.generic_handler(),))
    if _tls_config is not None:
        bound = server.add_secure_port(bind,
                                       _tls_config.server_credentials())
    else:
        bound = server.add_insecure_port(bind)
    if bound == 0:
        # grpc signals bind failure by returning port 0, not raising
        raise OSError(f"failed to bind gRPC server at {bind}")
    server.start()
    return server


_channel_cache: dict[str, grpc.Channel] = {}
_channel_lock = threading.Lock()


def channel(address: str) -> grpc.Channel:
    with _channel_lock:
        ch = _channel_cache.get(address)
        if ch is None:
            opts = [("grpc.max_receive_message_length", 256 << 20),
                    ("grpc.max_send_message_length", 256 << 20)]
            if _tls_config is not None:
                # cluster certs share one CN; targets are raw IPs
                opts.append(("grpc.ssl_target_name_override",
                             _tls_config.server_name))
                ch = grpc.secure_channel(
                    address, _tls_config.channel_credentials(), options=opts)
            else:
                ch = grpc.insecure_channel(address, options=opts)
            _channel_cache[address] = ch
        return ch


def drop_channel(address: str) -> None:
    with _channel_lock:
        ch = _channel_cache.pop(address, None)
    if ch is not None:
        ch.close()


class Stub:
    """Thin client for one service on one address."""

    def __init__(self, address: str, service: str):
        self.address = address
        self.service = service
        self._ch = channel(address)

    def call(self, method: str, request, resp_cls, timeout: float = 30.0):
        fn = self._ch.unary_unary(
            f"/{self.service}/{method}",
            request_serializer=type(request).SerializeToString,
            response_deserializer=resp_cls.FromString)
        return fn(request, timeout=timeout, metadata=_outgoing_metadata())

    def call_stream(self, method: str, request, resp_cls,
                    timeout: float = 300.0):
        fn = self._ch.unary_stream(
            f"/{self.service}/{method}",
            request_serializer=type(request).SerializeToString,
            response_deserializer=resp_cls.FromString)
        return fn(request, timeout=timeout, metadata=_outgoing_metadata())

    def stream_stream(self, method: str, request_iter, req_cls, resp_cls):
        fn = self._ch.stream_stream(
            f"/{self.service}/{method}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)
        return fn(request_iter, metadata=_outgoing_metadata())


MASTER_SERVICE = "swtpu.master.Master"
VOLUME_SERVICE = "swtpu.volume.VolumeServer"
FILER_SERVICE = "swtpu.filer.Filer"
# the message-queue broker's service (reference mq/broker.py:34 and
# shell/mq_commands.py:13): mq/broker serves it, mq/client, mq/consumer,
# shell/mq_commands and cluster.check dial it
MQ_SERVICE = "swtpu.mq.Broker"
