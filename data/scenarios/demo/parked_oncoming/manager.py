class SimulationManager:
    """Finish at t >= 20.0 s once the ego is past x = 174.82165480431237 (the
    parked car and a margin) and has met every oncoming car.  There is
    no timeout: an ego that stalls never finishes, and the caller's own
    time cap counts that as a failure."""

    def __init__(self, sim):
        pass

    def update(self, sim):
        ego = sim.ego
        passed = ego.x > 174.82165480431237 and all(
            c.x < ego.x for c in sim.cars if c.reverse)
        if sim.t >= 20.0 and passed:
            sim.finished = True
