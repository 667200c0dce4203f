"""A CPU stand-in for ``shm3d_torch.solve.graphs.ChunkGraph``: the same
host side (inputs, the stop slots, one read of the stop state a solve, the
launch counts of the iterations that ran), with the device program
emulated: the setup runs eagerly, and each chunk graph runs as its
conditional node does, its start condition from the predicate through the
plain version of the start kernel (``stop.chunk_start_torch``): a WHILE
node runs its body while the predicate holds, an IF node (MINRES's
iteration 0) once if it holds.  The stop test is the plain version
(``solve.stop``) there.

Launch counts as on the card: the first setup and one warm-up iteration a
body count as they launch; each body's launches are noted once (the
"capture", on scratch state), and a solve adds the noted launches of the
bodies that ran; the bodies themselves run under a recording that
discards their own counts, as a replay launches nothing from the host.
Each "capture" counts in ``graphs.CAPTURES`` as the card's does.
"""

from shm3d_torch.solve import graphs, stop


def _clone(state: dict) -> dict:
    return {k: v.clone() for k, v in state.items()}


class EmulatedChunks(graphs.ChunkGraph):
    def _build(self, inputs, params):
        self.inputs = _clone(inputs)
        self.state = _clone(self.setup(self.inputs))
        self.state["stop"], self.state["go"] = stop.new_state("cpu")
        self._write_params(params)
        self.start(self.state)
        for body in self.make_bodies(_clone(self.state)):  # the warm-up
            body()
        self.bodies = self.make_bodies(self.state)
        with self.setup_counts.recording():  # the setup's "capture"
            self.setup(self.inputs)
            self.start(_clone(self.state))
        graphs._captured()
        self.chunks = []
        for j, loop in self._kinds():        # each body's "capture"
            c = graphs.LaunchCounts()
            with c.recording():
                self.make_bodies(_clone(self.state))[j]()
            graphs._captured()
            self.chunks.append(((j, loop), c))

    def _write_params(self, params):
        self.state["stop"][:params.shape[0]] = params

    def _launch_setup(self):
        with graphs.LaunchCounts().recording():
            for k, v in self.setup(self.inputs).items():
                self.state[k].copy_(v)
            self.start(self.state)
        self.setup_counts.add()

    def _launch_chunk(self, i):
        (j, loop), _ = self.chunks[i]
        with graphs.LaunchCounts().recording():
            cond = stop.chunk_start_torch(self.state["go"])
            while cond:
                self.bodies[j]()
                cond = loop and bool(self.state["go"])
