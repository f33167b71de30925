"""mq.topic.* shell commands (reference command_mq_topic_list.go,
command_mq_topic_desc.go, command_mq_topic_configure.go). Brokers register
in the master cluster list; commands dial the first live broker.

The port's copy of seaweedfs_tpu/shell/mq_commands.py, every command. The
service name comes from the port's utils/rpc, where cluster.check reads it
too (the reference defines it here and in mq/broker.py).
"""

from __future__ import annotations

import argparse

from ..pb import mq_pb2 as mq
from ..utils.rpc import MQ_SERVICE, Stub
from .commands import CommandEnv, command


def _broker_addr(env: CommandEnv, opt_broker: str) -> str:
    """One resolution chain for every mq command: explicit flag, shell
    option, then master-cluster discovery."""
    return opt_broker or env.option.get("broker", "") or _find_broker(env)


def _broker_stub(env: CommandEnv, opt_broker: str) -> Stub:
    addr = _broker_addr(env, opt_broker)
    if not addr:
        raise RuntimeError("no broker configured; pass -broker host:port")
    return Stub(addr, MQ_SERVICE)


def _find_broker(env: CommandEnv) -> str:
    """Discover a live broker from the master cluster list (reference
    findBrokerBalancer: brokers register via KeepConnected; brokers
    serve gRPC on their registered address directly)."""
    from .commands import discover_cluster_node
    return discover_cluster_node(env, "broker")[0]


def _all_broker_addrs(env: CommandEnv) -> "list[str]":
    """Every live broker from the master cluster list."""
    from .commands import list_cluster_nodes
    return sorted(n.address for n in list_cluster_nodes(env, "broker"))


def _mq_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-broker", default="")
    return p


@command("mq.topic.list", "list message-queue topics")
def cmd_mq_topic_list(env: CommandEnv, args):
    opt = _mq_parser("mq.topic.list").parse_args(args)
    stub = _broker_stub(env, opt.broker)
    resp = stub.call("ListTopics", mq.ListTopicsRequest(),
                     mq.ListTopicsResponse)
    for t in resp.topics:
        env.println(f"{t.namespace}/{t.name}")
    env.println(f"{len(resp.topics)} topics")


@command("mq.topic.desc", "-topic ns/name: describe a topic's "
         "partitions", aliases=("mq.topic.describe",))
def cmd_mq_topic_desc(env: CommandEnv, args):
    p = _mq_parser("mq.topic.desc")
    p.add_argument("-topic", required=True)
    opt = p.parse_args(args)
    ns, _, name = opt.topic.partition("/")
    stub = _broker_stub(env, opt.broker)
    resp = stub.call("LookupTopicBrokers",
                     mq.LookupTopicBrokersRequest(
                         topic=mq.Topic(namespace=ns, name=name)),
                     mq.LookupTopicBrokersResponse)
    for a in resp.assignments:
        env.println(f"partition [{a.partition.range_start},"
                    f"{a.partition.range_stop}) -> {a.leader_broker}")
    env.println(f"{len(resp.assignments)} partitions")
    # registered record schema (ConfigureTopic record_type)
    try:
        gc = stub.call("GetTopicConfiguration",
                       mq.GetTopicConfigurationRequest(
                           topic=mq.Topic(namespace=ns, name=name)),
                       mq.GetTopicConfigurationResponse, timeout=5)
        if gc.record_type:
            from ..mq.schema import Schema
            sch = Schema.from_bytes(bytes(gc.record_type))
            fields = ", ".join(
                f.name for f in sch.record_type.fields)
            env.println(f"schema: {{{fields}}}")
        else:
            env.println("schema: (none)")
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (older broker without the RPC)
        pass
    # consumer groups: every live broker reports the groups ITS
    # coordinator manages (sub_coordinator.py); merge across brokers
    total_groups = 0
    for addr in (_all_broker_addrs(env)
                 or [_broker_addr(env, opt.broker)]):
        if not addr:
            continue
        try:
            gresp = Stub(addr, MQ_SERVICE).call(
                "DescribeConsumerGroups",
                mq.DescribeConsumerGroupsRequest(
                    topic=mq.Topic(namespace=ns, name=name)),
                mq.DescribeConsumerGroupsResponse, timeout=5)
        except Exception:  # noqa: BLE001 — dead broker mid-listing
            continue
        for g in gresp.groups:
            total_groups += 1
            env.println(f"group {g.name!r} gen {g.generation} "
                        f"(coordinator {addr}):")
            for m in g.members:
                parts = [f"[{p.range_start},{p.range_stop})"
                         for p in m.partitions]
                env.println(f"  member {m.instance_id}: "
                            f"{' '.join(parts) or '(idle)'}")
            for po in g.offsets:
                env.println(f"  committed [{po.partition.range_start},"
                            f"{po.partition.range_stop}): {po.committed}")
    env.println(f"{total_groups} consumer groups")


@command("mq.topic.configure", "-topic ns/name -partitions N: create or "
         "resize a topic")
def cmd_mq_topic_configure(env: CommandEnv, args):
    p = _mq_parser("mq.topic.configure")
    p.add_argument("-topic", required=True)
    p.add_argument("-partitions", type=int, default=4)
    opt = p.parse_args(args)
    ns, _, name = opt.topic.partition("/")
    stub = _broker_stub(env, opt.broker)
    stub.call("ConfigureTopic",
              mq.ConfigureTopicRequest(
                  topic=mq.Topic(namespace=ns, name=name),
                  partition_count=opt.partitions),
              mq.ConfigureTopicResponse)
    env.println(f"configured {opt.topic} with {opt.partitions} partitions")


@command("mq.balance", "re-derive topic partition assignments on the broker")
def cmd_mq_balance(env: CommandEnv, args):
    """Reference command_mq_balance.go: find the balancer broker via the
    master cluster list, trigger BalanceTopics, print the assignment."""
    opt = _mq_parser("mq.balance").parse_args(args)
    addr = _broker_addr(env, opt.broker)
    if not addr:
        env.println("no live broker in the cluster")
        return
    env.println(f"balancer: {addr}")
    resp = Stub(addr, MQ_SERVICE).call(
        "BalanceTopics", mq.BalanceTopicsRequest(), mq.BalanceTopicsResponse)
    for a in resp.assignments:
        env.println(f"{a.topic.namespace}/{a.topic.name}: "
                    f"{len(a.partitions)} partitions")
    env.println(f"balanced {len(resp.assignments)} topic(s)")
