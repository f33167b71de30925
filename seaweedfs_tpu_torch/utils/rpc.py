"""gRPC without grpcio-tools: generic method registration + client stubs
(the port's copy of the JAX package's utils/rpc.py).

Services are declared in code against the protoc-generated message classes
of `pb/`. The server side builds a GenericRpcHandler per service; the
client side wraps channel.unary_unary etc. with cached channels. The
service strings are the JAX package's, so its stubs reach the port's
servers and the other way round.

Not ported yet: the cluster key (bearer tokens) and mTLS. This module and
`pb/` are the only ones of the port, with `server/grpc_service.py`, that
import `grpc` or `google.protobuf`; the volume server's core never does.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Callable

import grpc


def _outgoing_metadata() -> list[tuple[str, str]]:
    # trace-context propagation: a sampled active span rides every gRPC
    # hop as traceparent metadata; unsampled/absent adds nothing
    from .. import tracing
    tp = tracing.injectable()
    return [(tracing.TRACEPARENT_HEADER, tp)] if tp else []


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


def _component_of(service: str) -> str:
    # "swtpu.master.Master" -> "master"
    parts = service.split(".")
    return parts[1] if len(parts) > 1 else service


class RpcService:
    """Declarative service: register handlers, then mount on a grpc.Server.

    Unary and server-streaming handlers run inside a tracing span
    (`rpc/<Method>`) parented on the caller's traceparent metadata;
    bidirectional streams (heartbeats) are not spanned."""

    def __init__(self, name: str):
        self.name = name  # e.g. "swtpu.volume.VolumeServer"
        self._handlers: dict[str, grpc.RpcMethodHandler] = {}
        self._component = _component_of(name)

    def _traced_unary(self, method: str, fn: Callable) -> Callable:
        from .. import tracing
        comp = self._component

        def wrapped(request, context):
            with tracing.start_span(
                    f"rpc/{method}", component=comp,
                    child_of=_extract_trace_context(context)) as sp:
                try:
                    return fn(request, context)
                except Exception as e:  # noqa: BLE001 — incl. grpc aborts
                    sp.set_error(e)
                    raise
        return wrapped

    def _traced_stream(self, method: str, fn: Callable) -> Callable:
        from .. import tracing
        comp = self._component

        def wrapped(request, context):
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
            self._handlers[method] = grpc.unary_stream_rpc_method_handler(
                self._traced_stream(method, fn),
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


def serve(bind: str, services: list[RpcService],
          max_workers: int = 16) -> grpc.Server:
    port = int(bind.rsplit(":", 1)[1])
    if not 0 < port < 65536:
        # grpc silently wraps port numbers modulo 65536, so an overflowed
        # "+10000 convention" port would bind somewhere surprising and
        # clients would talk to the wrong server — fail loudly instead
        raise ValueError(f"invalid port in bind address {bind!r}")
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers,
                                   thread_name_prefix="grpc-worker"),
        options=[("grpc.max_receive_message_length", 256 << 20),
                 ("grpc.max_send_message_length", 256 << 20)])
    for s in services:
        server.add_generic_rpc_handlers((s.generic_handler(),))
    if server.add_insecure_port(bind) == 0:
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
            ch = _channel_cache[address] = grpc.insecure_channel(
                address,
                options=[("grpc.max_receive_message_length", 256 << 20),
                         ("grpc.max_send_message_length", 256 << 20)])
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
