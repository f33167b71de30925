"""Distributed tracing: trace/span propagation across every cross-node
hop, a bounded span ring buffer, and the /debug/traces payload.

Public surface: start_span / add_event for instrumentation, inject /
extract / injectable for transports, BUFFER + debug_traces_payload for
the status servers, configure for tests and drills; and the port's own
`stage` (tracing/stages.py), a histogram timer that shows as a range in
a running device capture.
"""

from .trace import (
    BUFFER, Span, SpanContext, TRACEPARENT_HEADER, TraceBuffer, add_event,
    configure, current_ids, current_span, current_trace_id,
    debug_traces_payload, extract, inject, injectable, parse_traceparent,
    sample_rate, start_span,
)
from .stages import stage

__all__ = [
    "BUFFER", "Span", "SpanContext", "TRACEPARENT_HEADER", "TraceBuffer",
    "add_event", "configure", "current_ids", "current_span",
    "current_trace_id", "debug_traces_payload", "extract", "inject",
    "injectable", "parse_traceparent", "sample_rate", "stage", "start_span",
]
