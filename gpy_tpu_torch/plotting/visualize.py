"""Interactive data viewers for latent-space exploration.

Reference: GPy/plotting/matplot_dep/visualize.py (data_show base class,
vector_show, image_show, stick_show mocap viewer, lvm latent-space viewer
where dragging in latent space decodes through the model).

Each viewer holds matplotlib artists and updates them via `modify(y)`;
`lvm` additionally binds mouse-motion events so moving over the latent
axes decodes the hovered latent point live (usable in any interactive
matplotlib backend; under Agg the modify() path is still exercised).
"""
from __future__ import annotations

import numpy as np

from ..util.misc import param_to_array as _np

__all__ = ["data_show", "vector_show", "image_show", "stick_show", "lvm"]


class data_show:
    """Base viewer: subclasses draw y and update on modify(y)."""

    def __init__(self, vals):
        self.vals = np.asarray(vals).reshape(1, -1)

    def modify(self, vals):
        self.vals = np.asarray(vals).reshape(1, -1)
        self._redraw()

    def _redraw(self):
        raise NotImplementedError

    def close(self):
        pass


class vector_show(data_show):
    """Draw a data vector as a line (GPy visualize.vector_show)."""

    def __init__(self, vals, axes=None):
        super().__init__(vals)
        import matplotlib.pyplot as plt

        self.axes = axes or plt.subplots()[1]
        (self.handle,) = self.axes.plot(np.arange(self.vals.shape[1]), self.vals[0])

    def _redraw(self):
        self.handle.set_ydata(self.vals[0])
        self.axes.relim()
        self.axes.autoscale_view()


class image_show(data_show):
    """Draw a data vector as an image (GPy visualize.image_show)."""

    def __init__(self, vals, axes=None, dimensions=(16, 16), transpose=False,
                 invert=False, **kwargs):
        super().__init__(vals)
        import matplotlib.pyplot as plt

        self.dimensions = dimensions
        self.transpose = transpose
        self.invert = invert
        self.axes = axes or plt.subplots()[1]
        self.handle = self.axes.imshow(self._img(), cmap="gray")
        self.axes.set_xticks([])
        self.axes.set_yticks([])

    def _img(self):
        img = self.vals.reshape(self.dimensions)
        if self.transpose:
            img = img.T
        if self.invert:
            img = -img
        return img

    def _redraw(self):
        self.handle.set_data(self._img())
        self.handle.autoscale()


class stick_show(data_show):
    """Draw a mocap frame as a stick figure from xyz triples + connections
    (GPy visualize.stick_show)."""

    def __init__(self, vals, connect=None, axes=None):
        super().__init__(vals)
        import matplotlib.pyplot as plt

        self.connect = connect
        if axes is None:
            fig = plt.figure()
            axes = fig.add_subplot(111, projection="3d")
        self.axes = axes
        self.lines = []
        self._draw(initial=True)

    def _xyz(self):
        n = self.vals.shape[1] // 3
        return self.vals.reshape(3, n).T if False else self.vals[0].reshape(n, 3, order="F")

    def _draw(self, initial=False):
        xyz = self._xyz()
        if initial:
            (self.points,) = self.axes.plot(xyz[:, 0], xyz[:, 1], xyz[:, 2], ".")
            if self.connect is not None:
                I, J = np.nonzero(self.connect)
                for i, j in zip(I, J):
                    (ln,) = self.axes.plot(xyz[[i, j], 0], xyz[[i, j], 1], xyz[[i, j], 2], "-")
                    self.lines.append((ln, i, j))
        else:
            self.points.set_data_3d(xyz[:, 0], xyz[:, 1], xyz[:, 2])
            for ln, i, j in self.lines:
                ln.set_data_3d(xyz[[i, j], 0], xyz[[i, j], 1], xyz[[i, j], 2])

    def _redraw(self):
        self._draw(initial=False)


class lvm(data_show):
    """Latent-variable-model viewer: a latent-space scatter beside a data
    viewer; moving the mouse over the latent axes decodes the hovered
    point through model.predict (GPy visualize.lvm)."""

    def __init__(self, vals, model, data_visualize, latent_axes=None,
                 latent_index=(0, 1)):
        super().__init__(vals)
        import matplotlib.pyplot as plt

        self.model = model
        self.data_visualize = data_visualize
        self.latent_index = list(latent_index)
        if latent_axes is None:
            _, latent_axes = plt.subplots()
        self.latent_axes = latent_axes
        X = _np(model.qX.mean) if hasattr(model, "qX") else _np(model.latent_X)
        self.latent_axes.scatter(X[:, self.latent_index[0]], X[:, self.latent_index[1]],
                                 s=8, alpha=0.6)
        (self.pointer,) = self.latent_axes.plot([float(self.vals[0, self.latent_index[0]])],
                                                [float(self.vals[0, self.latent_index[1]])],
                                                "rx", mew=2)
        self.latent_dim = X.shape[1]
        canvas = self.latent_axes.figure.canvas
        self.cids = [canvas.mpl_connect("motion_notify_event", self.on_move)]

    def on_move(self, event):
        if event.inaxes is not self.latent_axes or event.xdata is None:
            return
        q = np.asarray(self.vals, dtype=float).reshape(1, -1)
        q[0, self.latent_index[0]] = event.xdata
        q[0, self.latent_index[1]] = event.ydata
        self.modify(q)

    def _redraw(self):
        self.pointer.set_data([float(self.vals[0, self.latent_index[0]])],
                              [float(self.vals[0, self.latent_index[1]])])
        mu, _ = self.model.predict(self.vals.reshape(1, -1))
        self.data_visualize.modify(np.asarray(mu))

    def close(self):
        canvas = self.latent_axes.figure.canvas
        for cid in self.cids:
            canvas.mpl_disconnect(cid)
