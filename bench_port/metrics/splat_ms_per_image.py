"""Milliseconds an image outside the camera passes: the image's wall
less the program's synchronised pass seconds, which leaves the beam
splat, the film's division and the set-up of the passes."""


def read(run):
    passes = run.drv.stats.get("loop_s", 0.0) + run.drv.stats.get(
        "boxwalk_s", 0.0)
    if not run.drv.images or not passes:
        return None
    return (sum(run.drv.walls) - passes) * 1e3 / run.drv.images
