"""Population-graph container. Port of
``nnx_ppo_tpu/networks/graph/graph.py``.

:class:`PopulationGraph` owns named :class:`Population` nodes and
:class:`Connection` edges. Each population sums its incoming edges (plus
``obs[input_from]`` for an input population), applies its activation
once, and exposes its output under ``output_to``. An edge of
``delay=0`` reads its source's output of the same step (the topological
order makes it available); ``delay=k`` reads k steps back from the
source's ring buffer, shared by all its outgoing edges.

Built in two phases, as in JAX: a mutable :class:`PopulationGraphBuilder`
(``add_input``, ``add_population``, ``add_output``, ``connect``), then
``finalize()`` returns the graph (delay-0 cycles rejected by Kahn's
topological sort, buffers sized). The builder takes an integer ``seed``
for the default ``Dense`` transforms, as the port's factories do.

The loss replay (:meth:`PopulationGraph.replay_sequence`, ``graph.py:
390-657``) condenses the full edge set into strongly connected
components (Tarjan, in JAX's group order): acyclic populations run over
the whole ``[T, B]`` sequence at once, delayed edges read their source's
sequence shifted in closed form, and each recurrent core loops over time
over its own populations and internal edges only. The order of the
summands follows JAX's, which decides the float results.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nnx_ppo_tpu_torch.core.struct import tree_map, tree_where
from nnx_ppo_tpu_torch.networks.feedforward import Dense
from nnx_ppo_tpu_torch.networks.graph.connection import Connection
from nnx_ppo_tpu_torch.networks.graph.population import Population
from nnx_ppo_tpu_torch.networks.types import (
    ModuleOutput,
    ModuleState,
    StatefulModule,
    _normalize_reg,
)


def _ring_write(buf: torch.Tensor, idx: torch.Tensor, value: torch.Tensor, L: int):
    """One-hot ring-buffer write shared by the step, the core's replay
    loop and the final-carry loop: ``(buf', idx')`` with ``value``
    written at slot ``idx`` and the index advanced mod ``L``."""
    mask = F.one_hot(idx.long(), L).bool()[:, :, None]
    return torch.where(mask, value[:, None, :], buf), (idx + 1) % L


def _ring_read(buf: torch.Tensor, idx: torch.Tensor, delay: int, L: int) -> torch.Tensor:
    """The slot written ``delay`` steps before ``idx``: ``[B, size]``."""
    batch = torch.arange(buf.shape[0], device=buf.device)
    return buf[batch, (idx.long() - delay) % L]


def _activate(pop: Population, x: torch.Tensor) -> torch.Tensor:
    return pop.activation(x) if pop.activation is not None else x


class PopulationGraphBuilder:
    """Mutable builder: ``add_population`` / ``add_input`` /
    ``add_output`` / ``connect``, then ``finalize()`` -> the
    :class:`PopulationGraph`."""

    def __init__(self, seed: int = 0):
        self._generator = torch.Generator().manual_seed(seed)
        self._pops: dict[str, Population] = {}
        self._conns: list[Connection] = []
        self._transforms: list[StatefulModule] = []
        self._finalized = False

    def add_population(self, name: str, size: int, *, activation: Optional[Callable] = None) -> None:
        """Register an internal population."""
        self._add_population(name, size, activation, input_from=None, output_to=None)

    def add_input(
        self, name: str, size: int, *, input_from: str, activation: Optional[Callable] = None
    ) -> None:
        """Register an input population reading ``obs[input_from]`` (added
        to its incoming edges' sum)."""
        self._add_population(name, size, activation, input_from=input_from, output_to=None)

    def add_output(
        self,
        name: str,
        size: int,
        *,
        output_to: Optional[str] = None,
        activation: Optional[Callable] = None,
    ) -> None:
        """Register an output population exposed under ``output_to``
        (default: its own name) in the output dict."""
        self._add_population(
            name, size, activation, input_from=None,
            output_to=output_to if output_to is not None else name,
        )

    def _add_population(self, name, size, activation, *, input_from, output_to):
        self._assert_not_finalized()
        if name in self._pops:
            raise ValueError(f"population {name!r} already exists")
        self._pops[name] = Population(
            name=name, size=size, activation=activation, input_from=input_from,
            output_to=output_to,
        )

    def connect(
        self,
        src: str,
        dst: str,
        *,
        transform: Optional[StatefulModule] = None,
        delay: int = 0,
        reciprocal: bool = False,
    ) -> None:
        """Directed edge ``src -> dst``; ``transform`` defaults to a linear
        ``Dense`` sized src -> dst. ``reciprocal=True`` also adds ``dst ->
        src`` with its own default ``Dense``."""
        if reciprocal and transform is not None:
            raise ValueError(
                "connect(reciprocal=True) requires the default transform; "
                "make two explicit connect() calls for custom transforms"
            )
        self._add_connection(src, dst, transform, delay)
        if reciprocal:
            self._add_connection(dst, src, None, delay)

    def _add_connection(self, src, dst, transform, delay):
        self._assert_not_finalized()
        if src not in self._pops:
            raise ValueError(f"unknown source population {src!r}")
        if dst not in self._pops:
            raise ValueError(f"unknown destination population {dst!r}")
        connection = Connection(src=src, dst=dst, delay=delay)
        if transform is None:
            transform = Dense.create(self._pops[src].size, self._pops[dst].size, self._generator)
        self._conns.append(connection)
        self._transforms.append(transform)

    def _assert_not_finalized(self):
        if self._finalized:
            raise RuntimeError("PopulationGraphBuilder already finalized")

    def finalize(self) -> "PopulationGraph":
        """Validate (delay-0 cycles, buffer sizes) and return the graph."""
        self._assert_not_finalized()
        self._finalized = True

        max_delay = {n: 0 for n in self._pops}
        for conn in self._conns:
            max_delay[conn.src] = max(max_delay[conn.src], conn.delay)
        pops = {
            n: Population(
                name=p.name, size=p.size, activation=p.activation, input_from=p.input_from,
                output_to=p.output_to, max_outgoing_delay=max_delay[n],
            )
            for n, p in self._pops.items()
        }

        # Kahn's sort over the delay-0 edges, in insertion order.
        delay0_succ: dict[str, list[str]] = {n: [] for n in pops}
        in_degree = {n: 0 for n in pops}
        for conn in self._conns:
            if conn.delay == 0:
                delay0_succ[conn.src].append(conn.dst)
                in_degree[conn.dst] += 1
        ready = [n for n in pops if in_degree[n] == 0]
        topo: list[str] = []
        while ready:
            n = ready.pop(0)
            topo.append(n)
            for m in delay0_succ[n]:
                in_degree[m] -= 1
                if in_degree[m] == 0:
                    ready.append(m)
        if len(topo) != len(pops):
            unresolved = [n for n in pops if n not in topo]
            raise ValueError(f"delay-0 cycle detected involving populations: {unresolved}")

        incoming: dict[str, tuple] = {n: () for n in pops}
        for i, conn in enumerate(self._conns):
            incoming[conn.dst] = incoming[conn.dst] + (i,)
        output_pops = tuple((p.output_to, n) for n, p in pops.items() if p.output_to is not None)
        return PopulationGraph(
            transforms=self._transforms,
            populations=tuple(pops.values()),
            connections=tuple(self._conns),
            topo_order=tuple(topo),
            incoming=tuple(sorted(incoming.items())),
            output_pops=output_pops,
        )


class PopulationGraph(StatefulModule):
    """A finalized population graph: :meth:`builder` -> build calls ->
    ``finalize()``. Carry ``{"populations": {name: {"buffer": [B, L,
    size], "buffer_idx": [B]} or {}}, "connections": (transform carry,
    ...)}``; extras ``{"connections": (transform extras, ...)}``."""

    def __init__(
        self,
        transforms: list[StatefulModule],
        populations: tuple[Population, ...],
        connections: tuple[Connection, ...],
        topo_order: tuple[str, ...],
        incoming: tuple,
        output_pops: tuple,
    ):
        super().__init__()
        self.transforms = nn.ModuleList(transforms)
        self.populations = populations
        self.connections = connections
        self.topo_order = topo_order
        self.incoming = incoming  # sorted ((pop_name, (edge index, ...)), ...)
        self.output_pops = output_pops  # ((output_key, pop_name), ...)
        # Carries are made on the module's device.
        self.register_buffer("_anchor", torch.zeros(0), persistent=False)

    @staticmethod
    def builder(seed: int = 0) -> PopulationGraphBuilder:
        return PopulationGraphBuilder(seed)

    def _incoming_of(self, name: str) -> tuple:
        for n, inds in self.incoming:
            if n == name:
                return inds
        return ()

    def forward(self, state, obs, rollout_extras=None, generator=None) -> ModuleOutput:
        """One step (``graph.py:241-320``), populations in topological
        order."""
        pop_state = state["populations"]
        conn_state = state["connections"]
        n_edges = len(self.transforms)
        conn_extras = (None,) * n_edges if rollout_extras is None else rollout_extras["connections"]
        first = next(iter(obs.values())) if isinstance(obs, dict) else obs
        batch_size, dev = first.shape[0], first.device
        pops = {p.name: p for p in self.populations}

        new_pop_state: dict[str, dict] = {}
        new_conn_state: list[Any] = list(conn_state)
        new_conn_extras: list[Any] = [None] * n_edges
        current: dict[str, torch.Tensor] = {}
        reg_loss: Any = torch.zeros((), device=dev)

        for pop_name in self.topo_order:
            pop = pops[pop_name]
            integrated = torch.zeros((batch_size, pop.size), device=dev)
            if pop.input_from is not None:
                integrated = integrated + obs[pop.input_from]
            for i in self._incoming_of(pop_name):
                conn = self.connections[i]
                if conn.delay == 0:
                    src_out = current[conn.src]
                else:
                    src = pop_state[conn.src]
                    src_out = _ring_read(
                        src["buffer"], src["buffer_idx"], conn.delay, pops[conn.src].max_outgoing_delay
                    )
                out = self.transforms[i](conn_state[i], src_out, conn_extras[i], generator)
                new_conn_state[i] = out.next_state
                new_conn_extras[i] = out.rollout_extras
                integrated = integrated + out.output
                reg_loss = reg_loss + out.regularization_loss
            current[pop_name] = _activate(pop, integrated)

            updated: dict[str, Any] = {}
            if pop.max_outgoing_delay > 0:
                updated["buffer"], updated["buffer_idx"] = _ring_write(
                    pop_state[pop_name]["buffer"], pop_state[pop_name]["buffer_idx"],
                    current[pop_name], pop.max_outgoing_delay,
                )
            new_pop_state[pop_name] = updated

        return ModuleOutput(
            next_state={"populations": new_pop_state, "connections": tuple(new_conn_state)},
            output={key: current[name] for key, name in self.output_pops},
            regularization_loss=reg_loss,
            metrics={},
            rollout_extras={"connections": tuple(new_conn_extras)},
        )

    def _condensation(self) -> tuple[tuple[str, ...], ...]:
        """SCC condensation of the full edge set (delay-0 and delayed) in
        topological order, each SCC's members in global topological order
        (``graph.py:321-388``, iterative Tarjan)."""
        names = [p.name for p in self.populations]
        succ: dict[str, list[str]] = {n: [] for n in names}
        for conn in self.connections:
            succ[conn.src].append(conn.dst)

        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[tuple[str, ...]] = []
        counter = [0]

        def strongconnect(root: str) -> None:
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on_stack.add(v)
                recurse = False
                for j in range(pi, len(succ[v])):
                    w = succ[v][j]
                    if w not in index:
                        work[-1] = (v, j + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if recurse:
                    continue
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    sccs.append(tuple(comp))
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])

        for n in names:
            if n not in index:
                strongconnect(n)
        sccs.reverse()  # Tarjan emits SCCs in reverse topological order.
        topo_pos = {n: i for i, n in enumerate(self.topo_order)}
        return tuple(tuple(sorted(comp, key=topo_pos.__getitem__)) for comp in sccs)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        """The fused loss replay of the whole graph (``graph.py:390-657``).

        Acyclic populations process the whole ``[T, B]`` sequence at once,
        each incoming edge through its transform's own
        ``replay_sequence``; a delay-``k`` edge reads its source's
        sequence shifted by ``k``, zeroed where a reset fell in steps
        ``[t-k, t-1]``, and its first ``k`` steps from the carry's ring
        buffer. A recurrent core (an SCC with a cycle through delayed
        edges) loops over T over its own populations and internal edges,
        with every edge from outside the core computed beforehand. The
        final ring buffers come from one transform-free loop of writes."""
        T, B = done_seq.shape
        dev = done_seq.device
        pop_state = state["populations"]
        conn_state = state["connections"]
        n_edges = len(self.transforms)
        conn_extras = (None,) * n_edges if extras_seq is None else extras_seq["connections"]
        pops = {p.name: p for p in self.populations}
        done = done_seq.bool()

        # prefix[t]: dones in steps [0, t-1]; [T+1, B].
        prefix = torch.cat(
            [torch.zeros((1, B), dtype=torch.long, device=dev), torch.cumsum(done.long(), dim=0)]
        )
        t_idx = torch.arange(T, device=dev)
        batch = torch.arange(B, device=dev)

        acts: dict[str, torch.Tensor] = {}
        new_conn_state: list[Any] = list(conn_state)
        reg_total: Any = torch.zeros((T, B), device=dev)

        def delayed_src_seq(src_name: str, k: int) -> torch.Tensor:
            """Closed-form delayed read of an already computed source."""
            src_pop = pops[src_name]
            L, size = src_pop.max_outgoing_delay, src_pop.size
            act_src = acts[src_name]
            if k < T:
                shifted = torch.cat([torch.zeros((k, B, size), device=dev), act_src[: T - k]])
            else:
                shifted = torch.zeros((T, B, size), device=dev)
            # Reads before the window come from the carry's ring buffer,
            # k - t slots before its write position.
            buf0 = pop_state[src_name]["buffer"]  # [B, L, size]
            idx0 = pop_state[src_name]["buffer_idx"].long()  # [B]
            read_pos = (idx0[None, :] + (t_idx[:, None] - k)) % L
            init_read = buf0[batch[None, :], read_pos]  # [T, B, size]
            # No reset allowed in steps [max(t-k, 0), t-1].
            win_start = torch.clamp(t_idx - k, min=0)
            no_reset = (prefix[t_idx] - prefix[win_start]) == 0
            base = torch.where((t_idx >= k)[:, None, None], shifted, init_read)
            return torch.where(no_reset[:, :, None], base, 0.0)

        def external_edge_seq(i: int) -> torch.Tensor:
            """Batched replay of edge i, whose source is already computed."""
            nonlocal reg_total
            conn = self.connections[i]
            src_seq = acts[conn.src] if conn.delay == 0 else delayed_src_seq(conn.src, conn.delay)
            out_seq, reg_seq, final_conn = self.transforms[i].replay_sequence(
                conn_state[i], src_seq, done_seq, conn_extras[i]
            )
            new_conn_state[i] = final_conn
            reg_total = reg_total + reg_seq
            return out_seq

        for group in self._condensation():
            has_cycle = len(group) > 1 or any(
                c.src == c.dst == group[0] for c in self.connections
            )
            if not has_cycle:
                pop = pops[group[0]]
                integrated = torch.zeros((T, B, pop.size), device=dev)
                if pop.input_from is not None:
                    integrated = integrated + obs_seq[pop.input_from]
                for i in self._incoming_of(pop.name):
                    integrated = integrated + external_edge_seq(i)
                acts[pop.name] = _activate(pop, integrated)
                continue

            # A recurrent core: a loop over T over its own members.
            members = set(group)
            internal_edges: list[int] = []
            ext_inputs = {n: torch.zeros((T, B, pops[n].size), device=dev) for n in group}
            for n in group:
                if pops[n].input_from is not None:
                    ext_inputs[n] = ext_inputs[n] + obs_seq[pops[n].input_from]
                for i in self._incoming_of(n):
                    if self.connections[i].src in members:
                        internal_edges.append(i)
                    else:
                        ext_inputs[n] = ext_inputs[n] + external_edge_seq(i)
            # Ring buffers in the loop: the sources of internal delayed edges.
            scan_buffered = sorted(
                {self.connections[i].src for i in internal_edges if self.connections[i].delay > 0},
                key=list(self.topo_order).index,
            )
            bufs = {
                n: (pop_state[n]["buffer"], pop_state[n]["buffer_idx"]) for n in scan_buffered
            }
            conns = {i: conn_state[i] for i in internal_edges}
            group_acts: dict[str, list[torch.Tensor]] = {n: [] for n in group}
            group_reg = []
            for t in range(T):
                current: dict[str, torch.Tensor] = {}
                new_conns = dict(conns)
                reg_t: Any = torch.zeros((B,), device=dev)
                for n in group:  # global topological order within the group
                    integrated = ext_inputs[n][t]
                    for i in self._incoming_of(n):
                        if i not in new_conns:  # external, computed above
                            continue
                        conn = self.connections[i]
                        if conn.delay == 0:
                            src_out = current[conn.src]
                        else:
                            buf, idx = bufs[conn.src]
                            src_out = _ring_read(buf, idx, conn.delay, pops[conn.src].max_outgoing_delay)
                        extras_t = tree_map(lambda x: x[t], conn_extras[i])
                        out = self.transforms[i](conns[i], src_out, extras_t)
                        new_conns[i] = out.next_state
                        integrated = integrated + out.output
                        reg_t = reg_t + _normalize_reg(out.regularization_loss, 1, B, dev)[0]
                    current[n] = _activate(pops[n], integrated)
                for n in scan_buffered:
                    buf, idx = _ring_write(*bufs[n], current[n], pops[n].max_outgoing_delay)
                    bufs[n] = (
                        torch.where(done[t][:, None, None], 0.0, buf),
                        torch.where(done[t], 0, idx),
                    )
                # The done reset of the internal transforms' carries.
                for i in internal_edges:
                    new_conns[i] = tree_where(
                        done[t], self.transforms[i].reset_state(new_conns[i]), new_conns[i]
                    )
                conns = new_conns
                for n in group:
                    group_acts[n].append(current[n])
                group_reg.append(reg_t)
            for n in group:
                acts[n] = torch.stack(group_acts[n])
            reg_total = reg_total + torch.stack(group_reg)
            for i in internal_edges:
                new_conn_state[i] = conns[i]

        outputs = {key: acts[name] for key, name in self.output_pops}

        # Final ring buffers: write act[t], then zero where done[t] (a
        # reset wipes the write of its own step, as in the step).
        final_pop_state: dict[str, dict] = {}
        for p in self.populations:
            if p.max_outgoing_delay == 0:
                final_pop_state[p.name] = {}
                continue
            buf, idx = pop_state[p.name]["buffer"], pop_state[p.name]["buffer_idx"]
            for t in range(T):
                buf, idx = _ring_write(buf, idx, acts[p.name][t], p.max_outgoing_delay)
                buf = torch.where(done[t][:, None, None], 0.0, buf)
                idx = torch.where(done[t], 0, idx)
            final_pop_state[p.name] = {"buffer": buf, "buffer_idx": idx}
        final_state = {"populations": final_pop_state, "connections": tuple(new_conn_state)}
        return outputs, reg_total, final_state

    def update_statistics(self, rollout_extras: Any, mesh: Any = None) -> "PopulationGraph":
        for transform, extras in zip(self.transforms, rollout_extras["connections"]):
            transform.update_statistics(extras, mesh=mesh)
        return self

    def initialize_state(self, batch_size: int) -> ModuleState:
        dev = self._anchor.device
        pop_state: dict[str, dict] = {}
        for pop in self.populations:
            entry: dict[str, Any] = {}
            if pop.max_outgoing_delay > 0:
                entry["buffer"] = torch.zeros(
                    (batch_size, pop.max_outgoing_delay, pop.size), device=dev
                )
                entry["buffer_idx"] = torch.zeros(batch_size, dtype=torch.int32, device=dev)
            pop_state[pop.name] = entry
        conn_state = tuple(t.initialize_state(batch_size) for t in self.transforms)
        return {"populations": pop_state, "connections": conn_state}

    def reset_state(self, prev_state: ModuleState) -> ModuleState:
        prev_pops = prev_state["populations"]
        new_pops: dict[str, dict] = {}
        for pop in self.populations:
            entry: dict[str, Any] = {}
            if pop.max_outgoing_delay > 0:
                entry["buffer"] = torch.zeros_like(prev_pops[pop.name]["buffer"])
                entry["buffer_idx"] = torch.zeros_like(prev_pops[pop.name]["buffer_idx"])
            new_pops[pop.name] = entry
        new_conns = tuple(
            t.reset_state(s) for t, s in zip(self.transforms, prev_state["connections"])
        )
        return {"populations": new_pops, "connections": new_conns}

