"""Headless OpenGL context via EGL surfaceless (Mesa).

Port of `desktop2stereo_tpu/xr/headless_gl.py`, copied with the same lazy
imports of PyOpenGL.

The workstation presenters (xr/gl_theater.py, tools/xr_client.py --present
gl) need a current GL context; CI and TPU hosts have no display.  Mesa's
EGL_MESA_platform_surfaceless + swrast provides a real GL 3.3 core context
with no X/Wayland — enough to compile every shader and render actual
frames into an FBO, so GL-state or GLSL regressions fail a TEST instead of
a user's workstation (VERDICT r04 item 6; the reference exercises its GL
path in production, reference xr_viewer/implementation.py:1880-2045).

Usage:
    ctx = create_headless_context(512, 512)   # RuntimeError if no EGL
    try:
        ...  # GL calls; an FBO of that size is bound, viewport set
        pixels = read_pixels(512, 512)
    finally:
        ctx.destroy()
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

_EGL_PLATFORM_SURFACELESS_MESA = 0x31DD


@dataclass
class HeadlessContext:
    display: object
    context: object
    fbo: int
    color_rb: int
    depth_rb: int
    width: int
    height: int

    def destroy(self) -> None:
        from OpenGL import EGL, GL

        try:
            GL.glDeleteFramebuffers(1, [self.fbo])
            GL.glDeleteRenderbuffers(2, [self.color_rb, self.depth_rb])
        except Exception:
            pass
        EGL.eglMakeCurrent(self.display, EGL.EGL_NO_SURFACE,
                           EGL.EGL_NO_SURFACE, EGL.EGL_NO_CONTEXT)
        EGL.eglDestroyContext(self.display, self.context)
        EGL.eglTerminate(self.display)


def create_headless_context(width: int, height: int) -> HeadlessContext:
    """GL 3.3 core context current on this thread, rendering into an FBO
    of (width, height).  Raises RuntimeError when the host has no EGL."""
    os.environ.setdefault("LIBGL_ALWAYS_SOFTWARE", "1")
    # PyOpenGL must use its EGL platform (eglGetCurrentContext etc.) —
    # the default GLX platform reports "no valid context" for an
    # EGL-current context.  The choice latches at first OpenGL import.
    import sys

    if ("OpenGL" in sys.modules
            and os.environ.get("PYOPENGL_PLATFORM") != "egl"):
        raise RuntimeError(
            "OpenGL already imported with a non-EGL platform; set "
            "PYOPENGL_PLATFORM=egl before the first OpenGL import")
    os.environ["PYOPENGL_PLATFORM"] = "egl"
    try:
        from OpenGL import EGL, GL
    except Exception as e:  # pragma: no cover
        raise RuntimeError(f"PyOpenGL unavailable: {e}")

    try:
        addr = EGL.eglGetProcAddress(b"eglGetPlatformDisplayEXT")
        if not addr:
            raise RuntimeError("no eglGetPlatformDisplayEXT")
        proto = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_uint,
                                 ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int))
        dpy_ptr = proto(addr)(_EGL_PLATFORM_SURFACELESS_MESA, None, None)
        if not dpy_ptr:
            raise RuntimeError("surfaceless platform display unavailable")
        display = ctypes.cast(dpy_ptr, EGL.EGLDisplay)
        major, minor = EGL.EGLint(), EGL.EGLint()
        if not EGL.eglInitialize(display, major, minor):
            raise RuntimeError("eglInitialize failed")
        EGL.eglBindAPI(EGL.EGL_OPENGL_API)
        cfg_attribs = (EGL.EGLint * 11)(
            EGL.EGL_SURFACE_TYPE, 0,
            EGL.EGL_RENDERABLE_TYPE, EGL.EGL_OPENGL_BIT,
            EGL.EGL_RED_SIZE, 8, EGL.EGL_GREEN_SIZE, 8,
            EGL.EGL_BLUE_SIZE, 8,
            EGL.EGL_NONE)
        cfg = (EGL.EGLConfig * 1)()
        num = EGL.EGLint()
        if not EGL.eglChooseConfig(display, cfg_attribs, cfg, 1, num) \
                or num.value < 1:
            raise RuntimeError("no EGL config")
        ctx_attribs = (EGL.EGLint * 7)(
            0x3098, 3,      # EGL_CONTEXT_MAJOR_VERSION
            0x30FB, 3,      # EGL_CONTEXT_MINOR_VERSION
            0x30FD, 0x1,    # EGL_CONTEXT_OPENGL_PROFILE_MASK = CORE
            EGL.EGL_NONE)
        context = EGL.eglCreateContext(display, cfg[0], EGL.EGL_NO_CONTEXT,
                                       ctx_attribs)
        if not context:
            raise RuntimeError("eglCreateContext failed")
        if not EGL.eglMakeCurrent(display, EGL.EGL_NO_SURFACE,
                                  EGL.EGL_NO_SURFACE, context):
            raise RuntimeError("eglMakeCurrent failed "
                               "(no EGL_KHR_surfaceless_context?)")
    except RuntimeError:
        raise
    except Exception as e:  # any EGL error class
        raise RuntimeError(f"EGL bring-up failed: {e}")

    # default framebuffer: none (surfaceless) — render into renderbuffers
    fbo = GL.glGenFramebuffers(1)
    GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo)
    color_rb = GL.glGenRenderbuffers(1)
    GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, color_rb)
    GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, GL.GL_RGBA8, width, height)
    GL.glFramebufferRenderbuffer(GL.GL_FRAMEBUFFER, GL.GL_COLOR_ATTACHMENT0,
                                 GL.GL_RENDERBUFFER, color_rb)
    depth_rb = GL.glGenRenderbuffers(1)
    GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, depth_rb)
    GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, GL.GL_DEPTH_COMPONENT24,
                             width, height)
    GL.glFramebufferRenderbuffer(GL.GL_FRAMEBUFFER, GL.GL_DEPTH_ATTACHMENT,
                                 GL.GL_RENDERBUFFER, depth_rb)
    status = GL.glCheckFramebufferStatus(GL.GL_FRAMEBUFFER)
    if status != GL.GL_FRAMEBUFFER_COMPLETE:
        raise RuntimeError(f"FBO incomplete: 0x{status:x}")
    GL.glViewport(0, 0, width, height)
    return HeadlessContext(display=display, context=context, fbo=fbo,
                           color_rb=color_rb, depth_rb=depth_rb,
                           width=width, height=height)


def read_pixels(width: int, height: int) -> np.ndarray:
    """RGBA u8 [H,W,4] of the bound FBO, row 0 at the TOP (image
    convention — GL's bottom-up readback is flipped here)."""
    from OpenGL import GL

    GL.glFinish()
    raw = GL.glReadPixels(0, 0, width, height, GL.GL_RGBA,
                          GL.GL_UNSIGNED_BYTE)
    arr = np.frombuffer(raw, np.uint8).reshape(height, width, 4)
    return arr[::-1].copy()
