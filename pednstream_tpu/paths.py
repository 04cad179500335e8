"""Weighted shortest paths on a small directed graph.

Route enumeration must reproduce the reference's path sets exactly, and
the reference enumerates with NetworkX, so this module ports the three
NetworkX pieces that ``routing.PathSetBuilder`` uses, keeping NetworkX's
iteration orders and tie-breaking:

* ``DiGraph.add_edge`` / ``copy`` adjacency order (a copy rebuilds each
  node's predecessor order from the successor lists);
* ``shortest_simple_paths(G, s, t, weight="weight")`` (Yen's algorithm
  with bidirectional Dijkstra spur searches);
* ``shortest_path_length(G, s, t, weight="weight")`` (Dijkstra).

Ported from NetworkX 3.6 (networkx/algorithms/simple_paths.py and
networkx/algorithms/shortest_paths/weighted.py), used under its license:

    Copyright (c) 2004-2025, NetworkX Developers
    Aric Hagberg <hagberg@lanl.gov>
    Dan Schult <dschult@colgate.edu>
    Pieter Swart <swart@lanl.gov>
    All rights reserved.

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions are
    met:

      * Redistributions of source code must retain the above copyright
        notice, this list of conditions and the following disclaimer.

      * Redistributions in binary form must reproduce the above
        copyright notice, this list of conditions and the following
        disclaimer in the documentation and/or other materials provided
        with the distribution.

      * Neither the name of the NetworkX Developers nor the names of its
        contributors may be used to endorse or promote products derived
        from this software without specific prior written permission.

    THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
    "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
    LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
    A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
    OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
    SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT
    LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE,
    DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY
    THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT
    (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE
    OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""

from heapq import heappop, heappush
from itertools import count


class NoPath(Exception):
    """No path joins the two nodes."""


class DiGraph:
    """Directed graph with one float ``weight`` per edge.

    ``succ[u]`` and ``pred[v]`` are insertion-ordered dicts, as in
    NetworkX, because search order decides ties between equal-length
    paths."""

    def __init__(self):
        self.succ = {}
        self.pred = {}
        self.weight = {}

    def _add_node(self, n):
        if n not in self.succ:
            self.succ[n] = {}
            self.pred[n] = {}

    def add_edge(self, u, v, weight=1.0):
        self._add_node(u)
        self._add_node(v)
        self.succ[u][v] = None
        self.pred[v][u] = None
        self.weight[(u, v)] = weight

    def has_edge(self, u, v):
        return (u, v) in self.weight

    def __contains__(self, n):
        return n in self.succ

    def copy(self):
        g = DiGraph()
        for n in self.succ:
            g._add_node(n)
        for u, nbrs in self.succ.items():
            for v in nbrs:
                g.add_edge(u, v, self.weight[(u, v)])
        return g


def shortest_path_length(G: DiGraph, source, target) -> float:
    """Weighted shortest-path length (Dijkstra, stopping at ``target``)."""
    if source not in G:
        raise KeyError(f"source node {source} not in graph")
    dist = {}
    seen = {source: 0}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        (d, _, v) = heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        if v == target:
            break
        for u in G.succ[v]:
            vu = d + G.weight[(v, u)]
            if u in dist:
                if vu < dist[u]:
                    raise ValueError("Contradictory paths found: negative weights?")
            elif u not in seen or vu < seen[u]:
                seen[u] = vu
                heappush(fringe, (vu, next(c), u))
    if target not in dist:
        raise NoPath(f"Node {target} not reachable from {source}")
    return dist[target]


def _bidirectional_dijkstra(G: DiGraph, source, target, ignore_nodes=None,
                            ignore_edges=None):
    if ignore_nodes and (source in ignore_nodes or target in ignore_nodes):
        raise NoPath(f"No path between {source} and {target}.")
    if source == target:
        return (0, [source])

    ignore_nodes = ignore_nodes or ()
    ignore_edges = ignore_edges or ()

    def succ(v):
        return [w for w in G.succ[v]
                if w not in ignore_nodes and (v, w) not in ignore_edges]

    def pred(v):
        return [w for w in G.pred[v]
                if w not in ignore_nodes and (w, v) not in ignore_edges]

    dists = [{}, {}]
    paths = [{source: [source]}, {target: [target]}]
    fringe = [[], []]
    seen = [{source: 0}, {target: 0}]
    c = count()
    heappush(fringe[0], (0, next(c), source))
    heappush(fringe[1], (0, next(c), target))
    neighs = [succ, pred]
    finalpath = []
    finaldist = None
    dir = 1
    while fringe[0] and fringe[1]:
        dir = 1 - dir
        (dist, _, v) = heappop(fringe[dir])
        if v in dists[dir]:
            continue
        dists[dir][v] = dist
        if v in dists[1 - dir]:
            return (finaldist, finalpath)

        for w in neighs[dir](v):
            minweight = G.weight[(v, w)] if dir == 0 else G.weight[(w, v)]
            vw_length = dists[dir][v] + minweight
            if w in dists[dir]:
                if vw_length < dists[dir][w]:
                    raise ValueError("Contradictory paths found: negative weights?")
            elif w not in seen[dir] or vw_length < seen[dir][w]:
                seen[dir][w] = vw_length
                heappush(fringe[dir], (vw_length, next(c), w))
                paths[dir][w] = paths[dir][v] + [w]
                if w in seen[0] and w in seen[1]:
                    totaldist = seen[0][w] + seen[1][w]
                    if finalpath == [] or finaldist > totaldist:
                        finaldist = totaldist
                        revpath = paths[1][w][:]
                        revpath.reverse()
                        finalpath = paths[0][w] + revpath[1:]
    raise NoPath(f"No path between {source} and {target}.")


class _PathBuffer:
    def __init__(self):
        self.paths = set()
        self.sortedpaths = []
        self.counter = count()

    def __len__(self):
        return len(self.sortedpaths)

    def push(self, cost, path):
        hashable_path = tuple(path)
        if hashable_path not in self.paths:
            heappush(self.sortedpaths, (cost, next(self.counter), path))
            self.paths.add(hashable_path)

    def pop(self):
        (cost, num, path) = heappop(self.sortedpaths)
        self.paths.remove(tuple(path))
        return path


def shortest_simple_paths(G: DiGraph, source, target):
    """Simple paths from ``source`` to ``target``, shortest first (Yen)."""
    if source not in G:
        raise KeyError(f"source node {source} not in graph")
    if target not in G:
        raise KeyError(f"target node {target} not in graph")

    def length_func(path):
        return sum(G.weight[(u, v)] for (u, v) in zip(path, path[1:]))

    list_a = []
    list_b = _PathBuffer()
    prev_path = None
    while True:
        if not prev_path:
            length, path = _bidirectional_dijkstra(G, source, target)
            list_b.push(length, path)
        else:
            ignore_nodes = set()
            ignore_edges = set()
            for i in range(1, len(prev_path)):
                root = prev_path[:i]
                root_length = length_func(root)
                for path in list_a:
                    if path[:i] == root:
                        ignore_edges.add((path[i - 1], path[i]))
                try:
                    length, spur = _bidirectional_dijkstra(
                        G, root[-1], target,
                        ignore_nodes=ignore_nodes, ignore_edges=ignore_edges,
                    )
                    list_b.push(root_length + length, root[:-1] + spur)
                except NoPath:
                    pass
                ignore_nodes.add(root[-1])

        if list_b:
            path = list_b.pop()
            yield path
            list_a.append(path)
            prev_path = path
        else:
            break
