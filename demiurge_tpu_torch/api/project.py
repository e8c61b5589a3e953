"""The Project session: the editor's state and its operators.

Counterpart of ``demiurge_tpu/api/project.py`` (the reference's Project
execution engine and UI state, src/Project.{h,cpp}).  A session holds the
grid, terrain, selection, named layers and the undo/redo stacks on one
device (``device="cuda"`` unless the caller asks for another), dispatches
the operators of ``ops`` and ``select``, and saves to a lossless ``.npz``
with the reference's keys, so a file saved by one package loads in the
other.

Undo follows the reference (UndoHistory.cpp:19-67, Texture.cpp:123-181):
an edit stores (old - new), computed on the host, compressed by the
fixed-accuracy codec (``native.snapc``, accuracy 1e-6); undo adds the
decoded diff back on the device and redo subtracts it.
``ReversibleHistory`` holds closure pairs (layer removal).

``render`` runs the appearance chain (``viz.appearance``) and the map
projection (``viz.projections``) on the session's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device
from ..native import snapc
from ..ops import adjust, blur, deterrace, erosion, flow, morphological, \
    noise, ocean, tectonics, temperature, thermal
from ..ops.brush import BrushParams, BrushStroke
from ..select import selection as sel_tools


# ---------------------------------------------------------------------------
# undo history (UndoHistory.h:14-58)
# ---------------------------------------------------------------------------


class SnapshotHistory:
    """Diff-based undo entry: stores the compressed (old - new); undo adds
    the diff, redo subtracts it.  ``accuracy=0`` is lossless."""

    def __init__(self, target: str, diff: np.ndarray, accuracy: float = 1e-6):
        self.target = target
        self._shape = diff.shape
        self._data = snapc.compress(np.asarray(diff, np.float32), accuracy)

    def diff(self, device) -> torch.Tensor:
        return host_to_device(snapc.decompress(self._data, self._shape),
                              device)

    def undo(self, project: "Project"):
        project._set_field(self.target, project._get_field(self.target)
                           + self.diff(project.device))

    def redo(self, project: "Project"):
        project._set_field(self.target, project._get_field(self.target)
                           - self.diff(project.device))

    @property
    def nbytes(self):
        return len(self._data)


class ReversibleHistory:
    """Closure pair (UndoHistory.h ReversibleHistory)."""

    def __init__(self, undo_fn: Callable, redo_fn: Callable):
        self._undo = undo_fn
        self._redo = redo_fn

    def undo(self, project):
        self._undo(project)

    def redo(self, project):
        self._redo(project)


class Layer:
    def __init__(self, name: str, data: torch.Tensor):
        self.name = name
        self.data = data


class Project:
    """A terrain-editing session on ``device``."""

    def __init__(self, width: int = 1000, height: int = 500,
                 coords=None, circumference: float = 42000.0,
                 device="cuda"):
        kw = {}
        if coords is not None:
            kw["coords"] = tuple(float(c) for c in coords)
        self.grid = Grid(width=width, height=height,
                         circumference=circumference, **kw)
        self.device = torch.device(device)
        self.file_new()

    # ---- state ------------------------------------------------------------

    def _zeros(self):
        return torch.zeros(self.grid.shape, dtype=torch.float32,
                           device=self.device)

    def file_new(self):
        """terrain = 0, sel = 1, one base layer (Project.cpp:69-115)."""
        self.terrain = self._zeros()
        self.sel = sel_tools.select_all(self.grid, self.device)
        self.layers: Dict[int, Layer] = {}
        self._next_layer_id = 0
        self.undo_stack: List = []
        self.redo_stack: List = []
        self.add_layer("Layer 0", self.terrain)

    def _get_field(self, name: str):
        if name == "terrain":
            return self.terrain
        if name == "sel":
            return self.sel
        if name.startswith("layer:"):
            return self.layers[int(name[6:])].data
        raise KeyError(name)

    def _set_field(self, name: str, value):
        if name == "terrain":
            self.terrain = value
        elif name == "sel":
            self.sel = value
        elif name.startswith("layer:"):
            self.layers[int(name[6:])].data = value
        else:
            raise KeyError(name)

    # ---- undo/redo (Project.cpp:375-399) ----------------------------------

    def add_history(self, entry):
        self.undo_stack.append(entry)
        self.redo_stack.clear()

    def _snapshot(self, target: str, old, new):
        self.add_history(SnapshotHistory(
            target, old.cpu().numpy() - new.cpu().numpy()))

    def undo(self):
        if not self.undo_stack:
            return False
        e = self.undo_stack.pop()
        e.undo(self)
        self.redo_stack.append(e)
        return True

    def redo(self):
        if not self.redo_stack:
            return False
        e = self.redo_stack.pop()
        e.redo(self)
        self.undo_stack.append(e)
        return True

    def _apply_terrain(self, new):
        self._snapshot("terrain", self.terrain, new)
        self.terrain = new

    def _apply_sel(self, new):
        self._snapshot("sel", self.sel, new)
        self.sel = new

    # ---- layers (LayerWindow) ---------------------------------------------

    def add_layer(self, name: str, data=None) -> int:
        lid = self._next_layer_id
        self._next_layer_id += 1
        if data is None:
            data = self._zeros()
        self.layers[lid] = Layer(name, data)
        return lid

    def remove_layer(self, lid: int):
        layer = self.layers.pop(lid)

        def _undo(p, lid=lid, layer=layer):
            p.layers[lid] = layer

        def _redo(p, lid=lid):
            p.layers.pop(lid)

        self.add_history(ReversibleHistory(_undo, _redo))

    # ---- operators ---------------------------------------------------------

    def gradient_noise(self, params: noise.NoiseParams,
                       blend_mode: str = "replace"):
        self._apply_terrain(noise.gradient_noise(
            self.terrain, self.sel, self.grid, params, blend_mode))

    def blur(self, radius: float):
        """Gaussian blur, blended by the fractional selection
        (Filter.cpp:51-68: ``fc = s*new + (1-s)*backup``)."""
        full = blur.blur(self.terrain, self.grid, radius)
        self._apply_terrain(self.sel * full + (1.0 - self.sel) * self.terrain)

    def offset(self, value: float):
        self._apply_terrain(adjust.offset(self.terrain, self.sel, value))

    def scale(self, factor: float):
        self._apply_terrain(adjust.scale(self.terrain, self.sel, factor))

    def thermal_erosion(self, steps: int = 1):
        h = self.terrain
        for _ in range(steps):
            h = thermal.thermal_erosion_step(h, self.grid)
        self._apply_terrain(h)

    def morphology(self, radius: float, op: str):
        self._apply_terrain(
            morphological.morphology(self.terrain, self.grid, radius, op))

    def flow_map(self, cfg: flow.FlowConfig = flow.FlowConfig()):
        """FlowFilter: overwrites the terrain with the flow map (as the
        reference does); undoable."""
        self._apply_terrain(flow.flow_filter(self.terrain, self.sel,
                                             self.grid, cfg))

    def landscape_evolution(self, cfg: erosion.ErosionConfig =
                            erosion.ErosionConfig(), iterations=None):
        self._apply_terrain(erosion.landscape_evolution(
            self.terrain, self.sel, self.grid, cfg, iterations=iterations))

    def deterrace(self, **kw):
        self._apply_terrain(deterrace.deterrace(self.terrain, self.grid,
                                                **kw))

    def ocean_currents(self, steps: int = 1,
                       cfg: ocean.OceanConfig = None):
        """Run the ocean-current solver against the current terrain.  The
        velocity persists on the session (``self.ocean_uv``); returns
        (u, v)."""
        cfg = cfg or ocean.OceanConfig(jacobi_iters=1000)
        if getattr(self, "ocean_uv", None) is None:
            self.ocean_uv = ocean.init_ocean(self.grid, self.device)
        u, v = self.ocean_uv
        for _ in range(steps):
            u, v, _, _ = ocean.ocean_step(u, v, self.terrain, self.grid, cfg)
        self.ocean_uv = (u, v)
        return u, v

    def temperature_sim(self, substeps: int = 10, *,
                        write_terrain: bool = True):
        """Seasonal climate model (the reference's Temperature filter).
        With ``write_terrain`` the terrain is (undoably) replaced by the
        temperature field, as the reference displays it; else the field is
        only stored on ``self.temperature``."""
        T = getattr(self, "temperature", None)
        ti = getattr(self, "_temperature_i", 0.0)
        if T is None:
            T = temperature.init_temperature(self.grid, self.device)
        T, ti = temperature.temperature_step(T, self.terrain, ti, self.grid,
                                             substeps=substeps)
        self.temperature = T
        self._temperature_i = ti
        if write_terrain:
            self._apply_terrain(T)
        return T

    def tectonics(self, steps: int = 70, plates=None):
        """Plate tectonics (the reference's Tectonics filter); undoable.
        The plates persist on ``self.plates``, so repeated runs continue
        the simulation."""
        cfg = tectonics.TectonicsConfig(steps=steps)
        plates = plates if plates is not None else getattr(self, "plates",
                                                           None)
        self.plates, new = tectonics.run_tectonics(self.terrain, self.grid,
                                                   cfg, plates=plates)
        self._apply_terrain(new)

    # ---- selection ----------------------------------------------------------

    def select_all(self):
        self._apply_sel(sel_tools.select_all(self.grid, self.device))

    def select_invert(self):
        self._apply_sel(sel_tools.invert(self.sel))

    def select_height(self, lower: float, upper: float, mode="replace"):
        cand = sel_tools.by_height(self.terrain, lower, upper)
        self._apply_sel(sel_tools.apply_selection(self.sel, cand, mode))

    def select_lasso(self, path, mode="replace"):
        self._apply_sel(sel_tools.lasso(self.sel, self.grid, path, mode))

    def select_grow(self, radius: float):
        self._apply_sel(sel_tools.grow(self.sel, self.grid, radius))

    def select_shrink(self, radius: float):
        self._apply_sel(sel_tools.shrink(self.sel, self.grid, radius))

    def select_border(self, radius: float):
        self._apply_sel(sel_tools.border(self.sel, self.grid, radius))

    def select_blur(self, radius: float):
        self._apply_sel(sel_tools.blur_selection(self.sel, self.grid, radius))

    # ---- brush --------------------------------------------------------------

    def brush_stroke(self, path, params=None):
        """Paint a stroke along ``path`` (a list of (s, t) points)."""
        stroke = BrushStroke(self.terrain, self.sel, self.grid,
                             params or BrushParams())
        for prev, pos in zip(path[:-1], path[1:]):
            stroke.segment(pos, prev)
        new, _diff = stroke.finish()
        self._apply_terrain(new)

    # ---- io -----------------------------------------------------------------

    def load_heightmap(self, path: str, scale: float = 1.0,
                       offset: float = 0.0):
        """file_load (Project.cpp:45-54): image -> heightfield.  Image row 0
        (top) is the north edge, flipped to row 0 = south."""
        from ..utils.png import read_png

        img = read_png(path)
        if img.ndim == 3:
            img = img[..., :3].mean(-1)
        img = img[::-1]
        if img.shape != self.grid.shape:
            raise ValueError(f"image {img.shape} on a {self.grid.shape} grid")
        self._apply_terrain(host_to_device(
            np.ascontiguousarray(img * scale + offset, np.float32),
            self.device))

    def export_png(self, path: str, bitdepth: int = 16,
                   lo: Optional[float] = None, hi: Optional[float] = None):
        """file_write (Project.cpp:56-67); 16-bit by default, over [lo, hi]
        (default: the terrain's range)."""
        from ..utils.png import write_png

        arr = self.terrain.cpu().numpy()[::-1]
        lo = float(arr.min()) if lo is None else lo
        hi = float(arr.max()) if hi is None else hi
        norm = (arr - lo) / max(hi - lo, 1e-12)
        write_png(path, norm, bitdepth=bitdepth)

    def save(self, path: str):
        """Lossless checkpoint (npz): terrain, sel, layers, grid, with the
        reference's keys."""
        layers = {f"layer_{lid}_{l.name}": l.data.cpu().numpy()
                  for lid, l in self.layers.items()}
        np.savez_compressed(
            path,
            terrain=self.terrain.cpu().numpy(),
            sel=self.sel.cpu().numpy(),
            coords=np.asarray(self.grid.coords),
            circumference=self.grid.circumference,
            **layers,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "Project":
        with np.load(path) as z:
            H, W = z["terrain"].shape
            p = cls(width=W, height=H, coords=tuple(z["coords"]),
                    circumference=float(z["circumference"]), device=device)

            def put(a):
                return host_to_device(np.asarray(a, np.float32), p.device)

            p.terrain = put(z["terrain"])
            p.sel = put(z["sel"])
            p.layers = {}
            for k in z.files:
                if k.startswith("layer_"):
                    _, lid, name = k.split("_", 2)
                    p.layers[int(lid)] = Layer(name, put(z[k]))
        if p.layers:
            p._next_layer_id = max(p.layers) + 1
        return p

    # ---- rendering ----------------------------------------------------------

    def render(self, layers=None, projection: str = "equirectangular",
               out_w: int = 800, out_h: int = 400, uv=None, **canvas_kw):
        """Appearance chain + projection -> (out_h, out_w, 4) RGBA on the
        session's device; pixels beyond the projection are (0.1, 0.1, 0.1,
        1).

        ``uv`` feeds VectorField layers (defaults to the session's ocean
        velocity when present).  The four channels share one gather."""
        from ..viz import CanvasParams, appearance, project_field

        if uv is None:
            uv = getattr(self, "ocean_uv", None)
        rgba = appearance.render(self.terrain, self.grid, layers, uv=uv)
        params = CanvasParams(projection=projection, **canvas_kw)
        img, oob = project_field(rgba.permute(2, 0, 1), params, self.grid,
                                 out_w, out_h)
        back = host_to_device(np.array([0.1, 0.1, 0.1, 1.0], np.float32),
                              self.device)
        return torch.where(oob[..., None], back, img.permute(1, 2, 0))
