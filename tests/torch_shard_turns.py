"""What the shards of one device cost, with and without host turns
(``parallel.mesh._Turn``; ``Mesh.run`` always takes turns, and this
script replaces ``_Turn`` by nothing to run the shards at once). Not a
test; run from the repo root:

    python tests/torch_shard_turns.py          # one card
    python tests/torch_shard_turns.py --cpu    # the CPU, at the tests' size

On the card it times, on the bench tracer scene at 512x512 (4 spp, 2
bounces, caller uniforms), ``trace_rays`` on all the rays, the same rays
as 4 slices issued one after another by one thread, and
``sharded_path_trace`` over 1, 2 and 4 shards taking turns and running at
once; then the flagship frame through DefaultRenderer.renderer
(``chip_smoke.FULL_CONFIG``) unsharded and over 1 and 2 shards, both ways.
Each line: 3 host-clock runs to a synchronise after a warm-up, in ms,
with the card's name and power limit; the profiled runs print the
device's idle share. About a minute on one H100.

With ``--cpu`` it times two frames of DefaultRenderer.renderer at 128 x
256 with tests/test_parallel_graph.py's config on the flagship scene
(16 lights, 8 objects), unsharded and over 8 CPU shards taking turns and
running at once: 3 host-clock runs after a warm-up, in s.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


_TURN = None


def at_once(mm, on: bool) -> None:
    """Make ``Mesh.run`` build no host turns (``on``), or the real ones."""
    global _TURN
    _TURN = _TURN or mm._Turn
    mm._Turn = (lambda timeout: None) if on else _TURN


def main():
    import torch

    import chip_smoke as cs
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.parallel import make_mesh
    from sailor_tpu_torch.parallel import mesh as mm
    from sailor_tpu_torch.raytracing import path_tracer as pt
    from sailor_tpu_torch.scenes import flagship_scene, tracer_scene

    card = cs._card()
    cuda_lib.load()

    def timed(label, fn, reps=3):
        fn()
        ms = [round(cs._wall_ms(fn)[0], 2) for _ in range(reps)]
        print(f"{label}: {ms} ms on {card}", flush=True)

    def mesh(n, turns):
        at_once(mm, not turns)
        return make_mesh(n)

    w = h = 512
    spp, bounces = 4, 2
    scene, cam, view, proj = tracer_scene(tracer="sweep")
    u = torch.rand((spp, 5 * bounces, w * h), generator=torch.Generator().manual_seed(11)).cuda()
    o, d = mm.global_rows_rays(cam, view, proj, width=w, rows=range(h), height=h)
    kw = dict(spp=spp, max_bounces=bounces)
    timed("trace_rays, all rays", lambda: pt.trace_rays(scene, o, d, uniforms=u, **kw))
    q = w * h // 4

    def in_turn():
        for i in range(4):
            s = slice(i * q, (i + 1) * q)
            pt.trace_rays(scene, o[s], d[s], uniforms=u[..., s], **kw)

    timed("trace_rays, 4 slices one after another", in_turn)
    for turns in (True, False):
        for n in (1, 2, 4):
            m = mesh(n, turns)
            timed(f"sharded_path_trace x{n} {'taking turns' if turns else 'at once'}",
                  lambda: mm.sharded_path_trace(scene, cam, view, proj, width=w, height=h,
                                                mesh=m, uniforms=u, **kw))
        m = mesh(4, turns)
        cs.profile(lambda: mm.sharded_path_trace(scene, cam, view, proj, width=w, height=h,
                                                 mesh=m, uniforms=u, **kw),
                   card, f"profile_trace_x4_{'turns' if turns else 'at_once'}")

    width, height, lights, objects = cs.FLAGSHIP
    fscene = flagship_scene(width, height, lights, objects)

    def frames(run):
        fg = cs._full_graph(width, height)
        state = {"s": fg.initial_state()}

        def one():
            fg.prepare(fscene, state["s"])
            state["s"] = run(fg, state["s"])[1]

        one()
        return one

    timed("flagship-full cached frame, unsharded", frames(lambda fg, s: fg.process(fscene, s)))
    for turns in (True, False):
        for n in (1, 2):
            m = mesh(n, turns)
            timed(f"flagship-full cached frame x{n} {'taking turns' if turns else 'at once'}",
                  frames(lambda fg, s: fg.process_sharded(fscene, s, m)))
        m = mesh(2, turns)
        cs.profile(frames(lambda fg, s: fg.process_sharded(fscene, s, m)), card,
                   f"profile_frame_x2_{'turns' if turns else 'at_once'}")


# tests/test_parallel_graph.py's _CONFIG
TEST_CONFIG = {
    "z_far": 100.0, "shadow_resolution": 128, "env_resolution": 16,
    "bin_capacity": 256, "bin_rounds": 2, "sky_clouds": True, "cloud_stride": 2,
}


def main_cpu():
    import time

    import torch

    import chip_smoke as cs
    from sailor_tpu_torch.parallel import make_mesh
    from sailor_tpu_torch.parallel import mesh as mm
    from sailor_tpu_torch.scenes import flagship_scene

    width, height = 128, 256
    scene = flagship_scene(width, height, 16, 8, device="cpu")

    def two_frames(run):
        fg = cs._full_graph(width, height, device="cpu", config=TEST_CONFIG)
        state = fg.initial_state()
        for _ in range(2):
            fg.prepare(scene, state)
            state = run(fg, state)[1]

    def timed(label, run, reps=3):
        two_frames(run)
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            two_frames(run)
            secs.append(round(time.perf_counter() - t0, 3))
        print(f"{label}: {secs} s on the CPU, torch threads {torch.get_num_threads()}",
              flush=True)

    timed("two frames, unsharded", lambda fg, s: fg.process(scene, s))
    for turns in (True, False):
        at_once(mm, not turns)
        m = make_mesh(8, device="cpu")
        timed(f"two frames x8 {'taking turns' if turns else 'at once'}",
              lambda fg, s: fg.process_sharded(scene, s, m))


if __name__ == "__main__":
    main_cpu() if "--cpu" in sys.argv[1:] else main()
