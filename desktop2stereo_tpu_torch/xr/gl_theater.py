"""PyOpenGL backend for the XR theater draw lists.

Port of `desktop2stereo_tpu/xr/gl_theater.py`, copied with the same guarded
import of PyOpenGL.

Renders xr/theater.py `DrawItem`s with OpenGL 3.3 core — the workstation
half of the reference's per-eye composition (reference
xr_viewer/implementation.py:1880-2045, shaders xr_viewer/glsl.py:3-791).
Three programs cover the whole theater:

- color:  per-vertex-color geometry (environment, beams, controllers,
  glow band) with the screen-light-spill modulation in the vertex stage
  (the reference's env lighting uniform path);
- tex:    textured quads (panorama sphere, OSD/keyboard overlays, frost
  veil via `textureLod` mip sampling — reference effects.py frost);
- screen: the DIBR stereo warp evaluated on the world-space screen mesh
  (the reference's fragment-shader warp, reference viewer.py:386-631),
  positioned by the same MVP as everything else.

The numpy rasterizer (xr/raster.py) is the behavioral reference for this
backend; both consume identical draw lists.  This module needs a current
GL context (glfw window or OpenXR session) — it is exercised on
workstations, not in the headless test environment, so it stays a thin
command-submission layer over the tested scene assembly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

try:  # PyOpenGL is a workstation-side dependency
    from OpenGL import GL
except Exception:  # pragma: no cover - import guard
    GL = None

# --------------------------------------------------------------- shaders ---

V_COMMON = """
#version 330 core
uniform mat4 u_mvp;
uniform float u_spill;
uniform vec3 u_spill_tint;
uniform vec3 u_screen_center;
in vec3 in_pos;
in vec2 in_uv;
in vec4 in_color;
out vec2 v_uv;
out vec4 v_color;
void main() {
    vec3 d = in_pos - u_screen_center;
    float w = u_spill / (1.0 + dot(d, d));
    vec3 c = clamp(in_color.rgb * (1.0 + w * u_spill_tint), 0.0, 1.0);
    v_color = vec4(c, in_color.a);
    v_uv = in_uv;
    gl_Position = u_mvp * vec4(in_pos, 1.0);
}
"""

F_COLOR = """
#version 330 core
uniform vec4 u_color;
in vec4 v_color;
out vec4 f_color;
void main() { f_color = v_color * u_color; }
"""

F_TEX = """
#version 330 core
uniform sampler2D u_tex;
uniform vec4 u_color;
uniform float u_lod;
in vec2 v_uv;
in vec4 v_color;
out vec4 f_color;
void main() {
    vec4 t = textureLod(u_tex, v_uv, u_lod);
    f_color = t * v_color * u_color;
}
"""

# The canonical DIBR warp fragment shader (GLSL port of
# ops/stereo.dibr_render; behavior of reference viewer.py:386-631):
# parallax shift from 3-tap pre-smoothed depth, nonlinear near-boost, edge
# falloff, soft disocclusion confidence, directional background inpaint
# with opposite-sweep fallback, border alpha clip, rounded-corner SDF,
# roll-aware parallax direction.
DIBR_FRAG = """
#version 330 core
uniform sampler2D u_color;
uniform sampler2D u_depth;
uniform float u_eye_offset;     // ±ipd/2 (uv units)
uniform float u_strength;
uniform float u_convergence;
uniform float u_roll;           // parallax-direction roll (radians)
uniform float u_corner_radius;  // rounded-corner SDF radius (uv units)
uniform vec2  u_texel;
in vec2 v_uv;
in vec4 v_color;
out vec4 f_color;

float smoothstep01(float x) { x = clamp(x, 0.0, 1.0); return x*x*(3.0-2.0*x); }
float depth_at(vec2 uv) { return texture(u_depth, uv).r; }

void main() {
    float par = u_eye_offset > 0.0 ? 1.0 : -1.0;
    vec2 pd = vec2(cos(u_roll), sin(u_roll));   // parallax direction
    vec2 ds = pd * u_texel;                     // per-axis pixel steps
    float d = depth_at(v_uv) * 0.7
            + depth_at(v_uv - par * 1.5 * ds) * 0.15
            + depth_at(v_uv + par * 1.5 * ds) * 0.15;
    float depth_inv = -d;
    float shaped = depth_inv * (1.0 + 0.35 * (1.0 - d));
    float ef = smoothstep01(v_uv.x / 0.05) * smoothstep01((1.0 - v_uv.x) / 0.05);
    float shift = u_eye_offset * (shaped + u_convergence) * u_strength * ef;
    vec2 suv = v_uv - shift * pd;
    vec3 color = texture(u_color, clamp(suv, 0.0, 1.0)).rgb;

    float jump = abs(depth_at(v_uv - par * 2.0 * ds) - depth_at(v_uv + par * 2.0 * ds));
    float conf = smoothstep01((jump - 0.04) / 0.06);
    if (suv.x < 0.0 || suv.x > 1.0 || suv.y < 0.0 || suv.y > 1.0) conf = 1.0;

    // directional background inpaint, forward sweep + fallback.  Sweep
    // direction is eye-independent: the reference's g_par_dir x
    // g_sweep_sign double sign-flip cancels to -(cos,sin) for both eyes.
    vec3 acc = vec3(0.0); float wsum = 0.0;
    vec2 sweep = -pd * u_texel.x;
    for (int i = 1; i <= 12; ++i) {
        vec2 o = v_uv + sweep * float(i);
        float sdinv = 1.0 - depth_at(o);
        if (sdinv > depth_inv + 0.012) {
            float w = exp(-float(i) * 0.15) * (1.0 + (sdinv - depth_inv) * 10.0);
            acc += texture(u_color, o).rgb * w;
            wsum += w;
            if (wsum > 5.0) break;
        }
    }
    if (wsum < 2.0) {
        // no early exit: the reference's phase-2 fallback sweeps all taps
        for (int i = 1; i <= 12; ++i) {
            vec2 o = v_uv - sweep * float(i);
            float sdinv = 1.0 - depth_at(o);
            if (sdinv > depth_inv + 0.012) {
                float w = exp(-float(i) * 0.2);
                acc += texture(u_color, o).rgb * w;
                wsum += w;
            }
        }
    }
    vec3 filled = wsum > 0.01 ? acc / wsum : texture(u_color, v_uv).rgb;
    vec3 rgb = mix(color, filled, conf);

    // screen-edge alpha clip (reference viewer.py:595-600)
    vec2 border = smoothstep(vec2(-0.001), vec2(0.001), suv)
                * smoothstep(vec2(1.001), vec2(0.999), suv);
    float alpha = min(border.x, border.y);

    // rounded corners via the rounded-box SDF (reference viewer.py:617-628)
    if (u_corner_radius > 0.0) {
        vec2 q = abs(v_uv - 0.5) - 0.5 + u_corner_radius;
        float sdf = length(max(q, vec2(0.0))) + min(max(q.x, q.y), 0.0)
                  - u_corner_radius;
        alpha = min(alpha, 1.0 - smoothstep(0.0, 0.01, sdf));
    }
    f_color = vec4(rgb * alpha, alpha);
}
"""

_STATIC_CACHE_MAX = 64
_TEX_CACHE_MAX = 16


def _compile(vs_src: str, fs_src: str) -> int:
    def shader(kind, src):
        s = GL.glCreateShader(kind)
        GL.glShaderSource(s, src)
        GL.glCompileShader(s)
        if not GL.glGetShaderiv(s, GL.GL_COMPILE_STATUS):
            raise RuntimeError(GL.glGetShaderInfoLog(s).decode())
        return s

    prog = GL.glCreateProgram()
    vs = shader(GL.GL_VERTEX_SHADER, vs_src)
    fs = shader(GL.GL_FRAGMENT_SHADER, fs_src)
    GL.glAttachShader(prog, vs)
    GL.glAttachShader(prog, fs)
    GL.glLinkProgram(prog)
    if not GL.glGetProgramiv(prog, GL.GL_LINK_STATUS):
        raise RuntimeError(GL.glGetProgramInfoLog(prog).decode())
    GL.glDeleteShader(vs)
    GL.glDeleteShader(fs)
    return prog


def _interleave(item) -> np.ndarray:
    n = item.verts.shape[0]
    out = np.zeros((n, 9), np.float32)
    out[:, :3] = item.verts
    if item.uvs is not None:
        out[:, 3:5] = item.uvs
    if item.colors is not None:
        c = np.asarray(item.colors, np.float32)
        out[:, 5:9] = c if c.shape[1] == 4 else np.concatenate(
            [c, np.ones((n, 1), np.float32)], axis=1)
    else:
        out[:, 5:9] = 1.0
    return out


class TheaterGL:
    """Draw-list renderer over an existing GL 3.3 context."""

    def __init__(self):
        if GL is None:
            raise RuntimeError("PyOpenGL is required for the GL theater "
                               "backend — `pip install PyOpenGL`")
        self.prog_color = _compile(V_COMMON, F_COLOR)
        self.prog_tex = _compile(V_COMMON, F_TEX)
        self.prog_screen = _compile(V_COMMON, DIBR_FRAG)
        self._uloc: Dict[Tuple[int, str], int] = {}
        self._vao_stream = GL.glGenVertexArrays(1)
        self._vbo_stream = GL.glGenBuffers(1)
        self._ebo_stream = GL.glGenBuffers(1)
        self._static: Dict[int, Tuple[int, int, int]] = {}  # id → vao,vbo,n
        self._textures: Dict[int, Tuple[int, tuple]] = {}
        self._frame_tex: Optional[int] = None
        self._depth_tex: Optional[int] = None
        self._frame_size: Tuple[int, int] = (0, 0)

    # -- uniforms --------------------------------------------------------------

    def _u(self, prog: int, name: str) -> int:
        key = (prog, name)
        if key not in self._uloc:
            self._uloc[key] = GL.glGetUniformLocation(prog, name)
        return self._uloc[key]

    # -- frame textures ----------------------------------------------------------

    def set_frame(self, rgb: np.ndarray, depth: Optional[np.ndarray]) -> None:
        """Upload the frame color (mipmapped, LOD bias −0.5 like reference
        xr_viewer/frame.py:28-60) and depth (R32F) once per frame."""
        h, w = rgb.shape[:2]
        if self._frame_tex is None or self._frame_size != (w, h):
            if self._frame_tex is not None:
                GL.glDeleteTextures([self._frame_tex, self._depth_tex])
            self._frame_tex = GL.glGenTextures(1)
            self._depth_tex = GL.glGenTextures(1)
            self._frame_size = (w, h)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._frame_tex)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                               GL.GL_LINEAR_MIPMAP_LINEAR)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                               GL.GL_LINEAR)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_S,
                               GL.GL_CLAMP_TO_EDGE)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_T,
                               GL.GL_CLAMP_TO_EDGE)
            GL.glTexParameterf(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_LOD_BIAS, -0.5)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._depth_tex)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                               GL.GL_LINEAR)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                               GL.GL_LINEAR)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_S,
                               GL.GL_CLAMP_TO_EDGE)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_T,
                               GL.GL_CLAMP_TO_EDGE)
        GL.glPixelStorei(GL.GL_UNPACK_ALIGNMENT, 1)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._frame_tex)
        GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGB8, w, h, 0, GL.GL_RGB,
                        GL.GL_UNSIGNED_BYTE, np.ascontiguousarray(rgb))
        GL.glGenerateMipmap(GL.GL_TEXTURE_2D)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._depth_tex)
        if depth is None:
            depth = np.zeros((1, 1), np.float32)
        # depth may arrive at MODEL resolution (the server ships the
        # model-res map — its bilinear upsample IS the full-res one,
        # sinks/xr.py); upload at its OWN dims — the shader samples by UV,
        # so a smaller R32F texture is exactly the reference's mip-free
        # LINEAR depth texture semantics (reference frame.py:44-57)
        dh, dw = depth.shape[:2]
        GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_R32F, dw, dh, 0,
                        GL.GL_RED, GL.GL_FLOAT,
                        np.ascontiguousarray(depth, np.float32))

    # -- item textures ------------------------------------------------------------

    def _item_texture(self, arr: np.ndarray, wrap_u: bool) -> int:
        # entries RETAIN the keying array: id(arr) of a freed ndarray can
        # be recycled by the next same-size allocation (overlay textures
        # re-render every 0.25-0.5 s), which would alias a stale texture
        key = id(arr)
        hit = self._textures.pop(key, None)
        if hit is not None and hit[1] == arr.shape and hit[2] is arr:
            self._textures[key] = hit  # refresh LRU order
            return hit[0]
        if hit is not None:
            GL.glDeleteTextures([hit[0]])
        tex = GL.glGenTextures(1)
        GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                           GL.GL_LINEAR)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                           GL.GL_LINEAR)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_S,
                           GL.GL_REPEAT if wrap_u else GL.GL_CLAMP_TO_EDGE)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_T,
                           GL.GL_CLAMP_TO_EDGE)
        h, w = arr.shape[:2]
        fmt = GL.GL_RGBA if arr.shape[-1] == 4 else GL.GL_RGB
        ifmt = GL.GL_RGBA8 if arr.shape[-1] == 4 else GL.GL_RGB8
        GL.glPixelStorei(GL.GL_UNPACK_ALIGNMENT, 1)
        GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, ifmt, w, h, 0, fmt,
                        GL.GL_UNSIGNED_BYTE, np.ascontiguousarray(arr))
        self._textures[key] = (tex, arr.shape, arr)
        while len(self._textures) > _TEX_CACHE_MAX:
            oldest = next(iter(self._textures))
            old, _shape, _ref = self._textures.pop(oldest)
            GL.glDeleteTextures([old])
        return tex

    # -- geometry ----------------------------------------------------------------

    def _bind_attribs(self) -> None:
        stride = 9 * 4
        GL.glEnableVertexAttribArray(0)
        GL.glVertexAttribPointer(0, 3, GL.GL_FLOAT, False, stride,
                                 GL.ctypes.c_void_p(0))
        GL.glEnableVertexAttribArray(1)
        GL.glVertexAttribPointer(1, 2, GL.GL_FLOAT, False, stride,
                                 GL.ctypes.c_void_p(12))
        GL.glEnableVertexAttribArray(2)
        GL.glVertexAttribPointer(2, 4, GL.GL_FLOAT, False, stride,
                                 GL.ctypes.c_void_p(20))

    def _geometry(self, item) -> Tuple[int, int]:
        """(vao, vertex_count) — static items (env/panorama) cached by
        identity, everything else streamed through a scratch buffer."""
        static = item.kind in ("env", "panorama")
        key = id(item)
        if static and key in self._static:
            vao, _vbo, n, ref = self._static[key]
            if ref is item:  # retained ref => id cannot have been recycled
                return vao, n
            GL.glDeleteVertexArrays(1, [vao])
            GL.glDeleteBuffers(1, [_vbo])
            del self._static[key]
        data = _interleave(item)
        if static:
            vao = GL.glGenVertexArrays(1)
            vbo = GL.glGenBuffers(1)
            GL.glBindVertexArray(vao)
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo)
            GL.glBufferData(GL.GL_ARRAY_BUFFER, data.nbytes, data,
                            GL.GL_STATIC_DRAW)
            self._bind_attribs()
            if len(self._static) >= _STATIC_CACHE_MAX:
                for k, (ov, ob, _n, _ref) in list(self._static.items())[:8]:
                    GL.glDeleteVertexArrays(1, [ov])
                    GL.glDeleteBuffers(1, [ob])
                    del self._static[k]
            self._static[key] = (vao, vbo, data.shape[0], item)
            return vao, data.shape[0]
        GL.glBindVertexArray(self._vao_stream)
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo_stream)
        GL.glBufferData(GL.GL_ARRAY_BUFFER, data.nbytes, data,
                        GL.GL_STREAM_DRAW)
        self._bind_attribs()
        return self._vao_stream, data.shape[0]

    # -- render -------------------------------------------------------------------

    def render(self, viewport: Tuple[int, int, int, int], clear, items,
               view: np.ndarray, proj: np.ndarray) -> None:
        """Draw one eye: `viewport` (x, y, w, h); the clear is scissored to
        it so side-by-side window halves clear independently."""
        x, y, w, h = (int(v) for v in viewport)
        GL.glViewport(x, y, w, h)
        GL.glEnable(GL.GL_DEPTH_TEST)
        GL.glDepthFunc(GL.GL_LESS)
        GL.glEnable(GL.GL_SCISSOR_TEST)
        GL.glScissor(x, y, w, h)
        GL.glClearColor(float(clear[0]), float(clear[1]), float(clear[2]), 1.0)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
        GL.glDisable(GL.GL_SCISSOR_TEST)
        mvp = np.ascontiguousarray((proj @ view).T, np.float32)  # column-major
        for item in items:
            self._draw_item(item, mvp)
        GL.glDisable(GL.GL_BLEND)
        GL.glDepthMask(True)

    def _draw_item(self, item, mvp: np.ndarray) -> None:
        uni = item.uniforms or {}
        if item.kind == "screen":
            prog = self.prog_screen
        elif (item.texture is not None or item.kind == "frost"
                or item.kind == "panorama"):
            prog = self.prog_tex
        else:
            prog = self.prog_color
        GL.glUseProgram(prog)
        GL.glUniformMatrix4fv(self._u(prog, "u_mvp"), 1, False, mvp)
        GL.glUniform1f(self._u(prog, "u_spill"), float(uni.get("spill", 0.0)))
        GL.glUniform3f(self._u(prog, "u_spill_tint"),
                       *uni.get("spill_tint", (0.0, 0.0, 0.0)))
        GL.glUniform3f(self._u(prog, "u_screen_center"),
                       *uni.get("screen_center", (0.0, 0.0, 0.0)))

        if prog == self.prog_screen:
            GL.glActiveTexture(GL.GL_TEXTURE0)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._frame_tex or 0)
            GL.glActiveTexture(GL.GL_TEXTURE1)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._depth_tex or 0)
            GL.glUniform1i(self._u(prog, "u_color"), 0)
            GL.glUniform1i(self._u(prog, "u_depth"), 1)
            GL.glUniform1f(self._u(prog, "u_eye_offset"),
                           float(uni.get("eye_offset", 0.0)))
            GL.glUniform1f(self._u(prog, "u_strength"),
                           float(uni.get("strength", 2.0)))
            GL.glUniform1f(self._u(prog, "u_convergence"),
                           float(uni.get("convergence", 0.0)))
            GL.glUniform1f(self._u(prog, "u_roll"),
                           float(uni.get("roll", 0.0)))
            GL.glUniform1f(self._u(prog, "u_corner_radius"),
                           float(uni.get("corner_radius", 0.0)))
            w, h = self._frame_size
            GL.glUniform2f(self._u(prog, "u_texel"),
                           1.0 / max(w, 1), 1.0 / max(h, 1))
        elif prog == self.prog_tex:
            GL.glActiveTexture(GL.GL_TEXTURE0)
            if item.kind == "frost" and item.texture is None:
                GL.glBindTexture(GL.GL_TEXTURE_2D, self._frame_tex or 0)
            else:
                GL.glBindTexture(GL.GL_TEXTURE_2D,
                                 self._item_texture(item.texture, item.wrap_u))
            GL.glUniform1i(self._u(prog, "u_tex"), 0)
            GL.glUniform1f(self._u(prog, "u_lod"),
                           float(uni.get("lod", 0.0)))
            GL.glUniform4f(self._u(prog, "u_color"), *item.color)
        else:
            GL.glUniform4f(self._u(prog, "u_color"), *item.color)

        # blending / depth state per item
        if item.blend == "additive":
            GL.glEnable(GL.GL_BLEND)
            GL.glBlendFunc(GL.GL_SRC_ALPHA, GL.GL_ONE)
        elif item.blend == "alpha" or prog == self.prog_screen:
            # the screen shader emits premultiplied edge alpha
            GL.glEnable(GL.GL_BLEND)
            if prog == self.prog_screen:
                GL.glBlendFunc(GL.GL_ONE, GL.GL_ONE_MINUS_SRC_ALPHA)
            else:
                GL.glBlendFunc(GL.GL_SRC_ALPHA, GL.GL_ONE_MINUS_SRC_ALPHA)
        else:
            GL.glDisable(GL.GL_BLEND)
        GL.glDepthMask(bool(item.depth_write and item.blend == "opaque"))
        if item.depth_test:
            GL.glEnable(GL.GL_DEPTH_TEST)
        else:
            GL.glDisable(GL.GL_DEPTH_TEST)

        vao, n = self._geometry(item)
        GL.glBindVertexArray(vao)
        gl_mode = (GL.GL_TRIANGLE_STRIP if item.mode == "strip"
                   else GL.GL_TRIANGLES)
        if item.indices is not None:
            idx = np.ascontiguousarray(item.indices, np.uint32)
            GL.glBindBuffer(GL.GL_ELEMENT_ARRAY_BUFFER, self._ebo_stream)
            GL.glBufferData(GL.GL_ELEMENT_ARRAY_BUFFER, idx.nbytes, idx,
                            GL.GL_STREAM_DRAW)
            GL.glDrawElements(gl_mode, idx.size, GL.GL_UNSIGNED_INT,
                              GL.ctypes.c_void_p(0))
        else:
            GL.glDrawArrays(gl_mode, 0, n)

    def release(self) -> None:
        for _k, (vao, vbo, _n, _ref) in self._static.items():
            GL.glDeleteVertexArrays(1, [vao])
            GL.glDeleteBuffers(1, [vbo])
        self._static.clear()
        for _k, (tex, _shape, _ref) in self._textures.items():
            GL.glDeleteTextures([tex])
        self._textures.clear()
