"""The port's headset input and session state machines against the JAX
package on the CPU.

One scripted event sequence, drawn from a seed, goes through both packages'
`input_map`, `input_router`, `controls` and `session` modules, and through
both clients' `OpenXRPresenter` driven by a fake runtime (the JAX suite's
way to run the presenter without a headset): the same actions, OS-input
events, phases, screen pose and knobs come out.  Then the input route back
over the connection: the port's presenter sends its laser events through
the port's `FrameNetClient.send_input` into the port's server and its
`InputBridge`, and the injector sees what the JAX chain gives it.
"""

import math

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from torch_xr_common import assert_same, client, xr

PKGS = ("jax", "port")


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _runs(rng, n, p_start=0.08, p_stop=0.2):
    """A boolean signal held for random runs (a button a user presses)."""
    out, on = [], False
    for _ in range(n):
        on = (rng.random() > p_stop) if on else (rng.random() < p_start)
        out.append(on)
    return out


def _stick(rng, n):
    """A stick pushed and released in runs, with values in and out of the
    dead zones."""
    held = _runs(rng, n, 0.1, 0.15)
    vals = rng.uniform(-1.0, 1.0, (n, 2))
    return [tuple(float(v) for v in vals[i]) if held[i] else (0.0, 0.0) for i in range(n)]


def controller_script(seed=0, n=400):
    rng = np.random.default_rng(seed)
    fields = {f: _runs(rng, n) for f in (
        "grip_l", "grip_r", "stick_btn_l", "stick_btn_r", "btn_a", "btn_b", "btn_x",
        "btn_y", "btn_menu", "laser_l_on_screen", "laser_r_on_screen",
        "keyboard_hover_l", "keyboard_hover_r")}
    # the long-hold combos (menu+A+B calibration, A+B seat) need long runs
    long_ab = _runs(rng, n, 0.01, 0.01)
    fields["btn_a"] = [a or b for a, b in zip(fields["btn_a"], long_ab)]
    fields["btn_b"] = [a or b for a, b in zip(fields["btn_b"], long_ab)]
    sticks = {"stick_l": _stick(rng, n), "stick_r": _stick(rng, n)}
    trig = {k: [float(v) for v in np.where(_runs(rng, n), rng.uniform(0.5, 1.0, n),
                                           rng.uniform(0.0, 0.2, n))]
            for k in ("trigger_l", "trigger_r")}
    dts = rng.choice([0.011, 0.05, 0.3, 1.2], n, p=[0.5, 0.3, 0.15, 0.05])
    return [({**{k: v[i] for k, v in fields.items()}, **{k: v[i] for k, v in sticks.items()},
              **{k: v[i] for k, v in trig.items()}}, float(dts[i])) for i in range(n)]


def test_chord_router_matches_jax():
    script = controller_script()
    out = {}
    for pkg in PKGS:
        ctl = xr(pkg, "controls")
        clk = Clock()
        router = ctl.ChordRouter(clock=clk)
        acts = []
        for fields, dt in script:
            clk.t += dt
            acts.append(router.update(ctl.ControllerState(**fields)))
            acts.append(router.update(ctl.ControllerState(**fields), now=clk.t + 1e-3))
        out[pkg] = acts
    assert_same(out["port"], out["jax"])
    assert sum(len(a) for a in out["port"]) > 100  # the script reaches many chords


def test_input_map_trackers_match_jax():
    rng = np.random.default_rng(1)
    n = 300
    trig = _runs(rng, n, 0.1, 0.3)
    xy = np.cumsum(rng.normal(0, 6, (n, 2)), axis=0) + 500
    uv = rng.uniform(-0.1, 1.1, (n, 2))
    has = _runs(rng, n, 0.3, 0.1)
    dist = rng.uniform(0.3, 4.0, (n, 2))
    sticks = _stick(rng, n)
    dts = rng.uniform(0.005, 0.2, n)
    pinch = [(tuple(uv[i]) if has[i] else None, tuple(uv[-1 - i]) if trig[i] else None)
             for i in range(n)]
    out = {}
    for pkg in PKGS:
        im = xr(pkg, "input_map")
        cur, arb, clicks = im.CursorMapper(1920, 1080), im.OwnershipArbiter(), im.ClickDragTracker()
        scroll, arrows, pin = im.ScrollAccumulator(), im.ArrowRepeater(), im.PinchTracker()
        t, seq = 0.0, []
        for i in range(n):
            t += float(dts[i])
            hit = tuple(uv[i]) if has[i] and 0 <= uv[i][0] <= 1 and 0 <= uv[i][1] <= 1 else None
            seq.append((cur.update(hit, tuple(uv[i]) if has[i] else None),
                        arb.decide(float(dist[i][0]) if trig[i] else None,
                                   float(dist[i][1]) if has[i] else None, now=t),
                        clicks.update(trig[i], float(xy[i][0]), float(xy[i][1]), now=t),
                        scroll.update(sticks[i][1], float(dts[i])),
                        arrows.update(*sticks[i], now=t), pin.update(*pinch[i])))
            if i == n // 2:
                cur.reset()
        out[pkg] = seq
    assert_same(out["port"], out["jax"])


def test_os_input_router_matches_jax():
    rng = np.random.default_rng(2)
    n = 300
    keys_idx = rng.integers(0, 80, n)
    out = {}
    for pkg in PKGS:
        ir, kb = xr(pkg, "input_router"), xr(pkg, "keyboard")
        keys = kb.build_layout()
        router = ir.OsInputRouter((1920, 1080))
        r = np.random.default_rng(3)
        trig = {h: _runs(r, n, 0.1, 0.25) for h in ("left", "right")}
        on_screen = {h: _runs(r, n, 0.3, 0.1) for h in ("left", "right")}
        on_kb = {h: _runs(r, n, 0.05, 0.3) for h in ("left", "right")}
        uv = r.uniform(-0.05, 1.05, (n, 2, 2))
        sticks = [_stick(r, n), _stick(r, n)]
        t, seq = 0.0, []
        for i in range(n):
            t += 1 / 72
            hands = {}
            for j, h in enumerate(("left", "right")):
                hi = ir.HandInput(trigger=0.9 if trig[h][i] else 0.0)
                if on_screen[h][i]:
                    hi.screen_uv = tuple(float(v) for v in np.clip(uv[i, j], 0, 1))
                    hi.plane_uv = tuple(float(v) for v in uv[i, j])
                    hi.screen_dist = 3.0
                if on_kb[h][i]:
                    hi.kb_key, hi.kb_dist = keys[int(keys_idx[i])], 0.6
                hands[h] = hi
            if i == n // 3:
                router.set_frame_size(1280, 720)
            ev = router.update(hands, scroll_xy=sticks[0][i], arrow_xy=sticks[1][i],
                               dt=1 / 72, now=t)
            seq.append((ev, router.state))
        out[pkg] = seq
    assert_same(out["port"], out["jax"])
    assert sum(len(e) for e, _ in out["port"]) > 50


def _fake_session_runtime(pkg, appear_after=0, reject=()):
    s = xr(pkg, "session")

    class FakeRuntime:
        def __init__(self):
            self.probes, self.calls = 0, []

        def probe_system(self):
            self.probes += 1
            if self.probes <= appear_after:
                return None
            return s.SystemInfo(recommended_size=(2064, 2208),
                                color_formats=(s.GL_RGBA8, s.GL_SRGB8_ALPHA8),
                                reference_spaces=(s.ReferenceSpace.LOCAL,
                                                  s.ReferenceSpace.STAGE))

        def create_session(self, space, swapchains):
            self.calls.append(("create", space, tuple(swapchains)))

        def destroy_session(self):
            self.calls.append(("destroy",))

        def suggest_bindings(self, profile, bindings):
            self.calls.append(("suggest", profile, tuple(bindings)))
            return profile not in reject

    return FakeRuntime()


def test_session_manager_matches_jax():
    rng = np.random.default_rng(4)
    phases = rng.integers(0, 7, 200)
    pads = rng.uniform(-1, 1, (20, 2))
    out = {}
    for pkg in PKGS:
        s = xr(pkg, "session")
        rt = _fake_session_runtime(pkg, appear_after=2,
                                   reject=("/interaction_profiles/htc/vive_controller",))
        mgr = s.SessionManager(rt, retry_delay=0.1, poll_step=0.05)
        slept = []
        info = mgr.wait_for_device(lambda: False, sleep=slept.append)
        mgr.bring_up()
        trace = [info, len(slept), mgr.space, mgr.swapchains, mgr.bound_profiles]
        members = list(s.SessionPhase)
        for p in phases:
            ph = members[int(p) % len(members)]
            trace.append((mgr.on_state(ph), mgr.phase, mgr.should_render))
        mgr.tear_down()
        ft = s.FrameTimer()
        trace += [rt.calls, mgr.phase, ft.push_period_ns(11_111_111), ft.push_period_ns(0),
                  [ft.push_timestamp(i / 90.0) for i in range(12)],
                  [s.trackpad_button_zone(x, y) for x, y in pads],
                  s.choose_color_format([s.GL_RGBA8]), s.choose_color_format([0x1234]),
                  s.choose_reference_space([s.ReferenceSpace.LOCAL]), s.BINDING_TABLES]
        stop = {"n": 0}

        def should_stop():
            stop["n"] += 1
            return stop["n"] > 5

        trace.append(s.SessionManager(_fake_session_runtime(pkg, appear_after=100),
                                      retry_delay=0.1, poll_step=0.05)
                     .wait_for_device(should_stop, sleep=lambda _s: None))
        out[pkg] = trace
    assert_same(out["port"], out["jax"])


# ---- the OpenXR presenter through a fake runtime ----------------------------------------


def fake_xr_runtime(pkg):
    """The JAX suite's `_FakeXrRuntime` for either package's session module,
    with controllers and aim poses scripted by the test."""
    s, XC = xr(pkg, "session"), client(pkg)

    class FakeXrRuntime:
        def __init__(self):
            self._SP = s.SessionPhase
            self._info = s.SystemInfo(
                recommended_size=(64, 64), color_formats=(s.GL_SRGB8_ALPHA8,),
                reference_spaces=(s.ReferenceSpace.STAGE, s.ReferenceSpace.LOCAL))
            self.calls, self.renders = [], []
            self.session_created = self.destroyed = False
            self._pending_phases = [s.SessionPhase.SYNCHRONIZED, s.SessionPhase.VISIBLE,
                                    s.SessionPhase.FOCUSED]
            self._time = 1000

        def probe_system(self):
            return self._info

        def create_session(self, space, swapchains):
            self.calls.append("create_session")
            self.session_created = True

        def destroy_session(self):
            self.calls.append("destroy_session")
            self.destroyed = True

        def suggest_bindings(self, profile, bindings):
            return "oculus" in profile

        def poll_phase_events(self):
            phases, self._pending_phases = self._pending_phases, []
            return phases

        def wait_frame(self):
            self.calls.append("wait_frame")
            self._time += 16_000_000
            return self._time, True

        def begin_frame(self):
            self.calls.append("begin_frame")

        def locate_views(self, display_time):
            self.calls.append("locate_views")
            q = (0.0, 0.0, math.sin(math.pi / 12), math.cos(math.pi / 12))
            return [XC.XrView(orientation_xyzw=q), XC.XrView(orientation_xyzw=q)]

        def render_eye(self, eye, rgb, depth, view, *, eye_offset, strength,
                       convergence, roll):
            self.renders.append((eye, eye_offset, strength, convergence, roll))

        def end_frame(self, display_time, rendered):
            self.calls.append(f"end_frame:{rendered}")

    return FakeXrRuntime()


@pytest.fixture
def frozen_clocks(monkeypatch):
    """time.perf_counter and time.monotonic stepped by the test, so the
    presenters' per-frame dt (and the chord router's hold times) are the
    same in both packages."""
    import time

    clk = Clock(1000.0)
    monkeypatch.setattr(time, "perf_counter", clk)
    monkeypatch.setattr(time, "monotonic", clk)
    return clk


def test_openxr_presenter_chords_match_jax(frozen_clocks):
    """The same controller script through both presenters: the same screen
    pose, depth strength, ui toggles, render calls and OSD state after
    every frame."""
    script = controller_script(seed=5, n=240)
    rng = np.random.default_rng(6)
    aims = rng.normal(0, 0.25, (len(script), 2, 3)) + [0.0, 0.0, -1.0]
    rgb = np.zeros((18, 32, 3), np.uint8)
    out = {}
    for pkg in PKGS:
        ctl, XC = xr(pkg, "controls"), client(pkg)
        rt = fake_xr_runtime(pkg)
        it = iter(range(len(script)))
        step = {"i": 0}

        def sample(rt=rt, ctl=ctl):
            i = step["i"]
            rt.last_aim = {"l": (np.array([-0.2, 1.3, 0.0]), aims[i, 0]),
                           "r": (np.array([0.2, 1.3, 0.0]), aims[i, 1])}
            return ctl.ControllerState(**script[i][0])

        rt.sample_controllers = sample
        sent = []
        frozen_clocks.t = 1000.0
        p = XC.OpenXRPresenter(0.064, 2.0, 0.01, runtime=rt, input_sink=sent.append)
        trace = []
        for i in it:
            step["i"] = i
            frozen_clocks.t += script[i][1]
            alive = p.push_packet(rgb, None)
            th = p.theater
            trace.append((alive, p.screen, p.strength, dict(p.ui_state), th.kb_hover,
                          th.kb_pressed, th.vendor, [(b.hand, b.hit) for b in th.lasers],
                          p.session.phase, p.frames_rendered))
        p.close()
        out[pkg] = [trace, rt.calls, rt.renders, sent]
    assert_same(out["port"], out["jax"])
    assert len(out["port"][3]) > 10  # OS-input events reached the sink


def test_openxr_presenter_action_semantics_match_jax(frozen_clocks):
    out = {}
    kinds = ["depth_scale", "depth_ratio_fine", "reset_depth_scale", "reset_depth_ratio",
             "toggle_depth_zero", "screen_width", "screen_distance", "screen_translate_x",
             "screen_translate_y", "screen_yaw", "screen_pitch", "reset_screen_pose",
             "reset_screen_orientation", "cycle_screen_preset", "cycle_controller_brand",
             "toggle_screen_curve", "cycle_background", "effect_transparency",
             "toggle_fps_overlay", "toggle_help_panel", "toggle_keyboard", "toggle_glow_mode",
             "toggle_passthrough", "toggle_all_overlays", "mouse_scroll_x", "arrow_y"]
    rng = np.random.default_rng(7)
    seq = [(kinds[int(k)], float(v), float(dt)) for k, v, dt in
           zip(rng.integers(0, len(kinds), 120), rng.uniform(-1, 1, 120),
               rng.uniform(0.0, 0.3, 120))]
    for pkg in PKGS:
        ctl, XC = xr(pkg, "controls"), client(pkg)
        p = XC.OpenXRPresenter(0.064, 2.0, 0.01, runtime=fake_xr_runtime(pkg))
        trace = []
        for kind, v, dt in seq:
            p._apply_action(ctl.Action(kind, v), dt)
            trace.append((p.screen, p.strength, dict(p.ui_state), p._axes, p.theater.vendor))
        out[pkg] = trace
    assert_same(out["port"], out["jax"])


def test_openxr_presenter_without_pyopenxr_exits_like_jax():
    import argparse

    args = argparse.Namespace(ipd=0.064, depth_strength=2.0, convergence=0.01, out="/tmp/x",
                              roll=0.0, corner_radius=0.0, theater="off")
    msgs = []
    for pkg in PKGS:
        with pytest.raises(SystemExit, match="openxr presenter unavailable") as e:
            client(pkg).make_presenter("openxr", args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_laser_input_reaches_the_injector_over_the_port_connection():
    """Port presenter → port FrameNetClient.send_input → port FrameNetServer
    → InputBridge → recording injector, against the same script through the
    JAX chain."""
    out = {}
    script = [((0.0, 1.4, 0.0), (0.0, 0.0, -1.0), 0.0),
              ((0.0, 1.4, 0.0), (0.0, 0.0, -1.0), 1.0),
              ((0.0, 1.4, 0.0), (0.3, 0.0, -1.0), 1.0),
              ((0.0, 1.4, 0.0), (0.3, 0.0, -1.0), 0.0)]
    for pkg in PKGS:
        ctl, XC = xr(pkg, "controls"), client(pkg)
        fs_mod, net, inj_mod = xr(pkg, "frame_server"), xr(pkg, "net"), xr(pkg, "injector")
        inj = inj_mod.RecordingInjector()
        bridge = inj_mod.InputBridge(inj, screen_size=(1920, 1080))
        srv = net.FrameNetServer(fs_mod.FrameServer(), host="127.0.0.1", port=0,
                                 on_input=bridge.handle).start()
        conn = net.FrameNetClient(host="127.0.0.1", port=srv.port)
        try:
            rt = fake_xr_runtime(pkg)
            step = {"i": 0}

            def sample(rt=rt, ctl=ctl):
                origin, direction, trig = script[min(step["i"], len(script) - 1)]
                rt.last_aim = {"r": (np.array(origin), np.array(direction))}
                step["i"] += 1
                return ctl.ControllerState(trigger_r=trig)

            rt.sample_controllers = sample
            p = XC.OpenXRPresenter(0.064, 2.0, 0.01, runtime=rt,
                                   input_sink=conn.send_input)
            for _ in script:
                assert p.push_packet(np.zeros((1080, 1920, 3), np.uint8), None)
            p.close()
        finally:
            conn.close()
            srv.close()
        out[pkg] = list(inj.events)
    assert_same(out["port"], out["jax"])
    kinds = [e[0] for e in out["port"]]
    assert "move" in kinds and ("button", 1, True) in out["port"]
    assert ("button", 1, False) in out["port"]
