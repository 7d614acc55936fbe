"""Motion-capture file support: Acclaim ASF/AMC skeletons and OSU text data.

Reference: GPy/util/mocap.py (721 LoC — vertex/tree containers, a
line-state-machine ASF parser, recursive forward kinematics, OSU text
loaders). This is a fresh implementation with the same conventions
(row-vector rotation matrices composed in reversed channel order, bone
rotation R = Cinv @ Rdof @ C @ Rparent, xyz = parent + offset @ R) but a
section-based parser and iterative (topologically ordered) FK.

Counterpart of gpy_tpu/util/mocap.py, numpy only: mocap parsing is data
loading on the host.
"""
from __future__ import annotations

import math
import os

import numpy as np

__all__ = [
    "Vertex", "Tree", "Skeleton", "AcclaimSkeleton", "rotation_matrix",
    "load_text_data", "parse_text", "read_connections",
    # GPy-style lowercase aliases (GPy/util/mocap.py:6,17,164,204)
    "vertex", "tree", "skeleton", "acclaim_skeleton",
]


class Vertex:
    """A named node in a skeleton tree. GPy: mocap.py:6-15."""

    def __init__(self, name, id, parents=None, children=None, meta=None):
        self.name = name
        self.id = id
        self.parents = list(parents) if parents is not None else []
        self.children = list(children) if children is not None else []
        self.meta = dict(meta) if meta is not None else {}

    def __str__(self):
        return f"{self.name} ({self.id})"


class Tree:
    """Vertex container with parent/child resolution. GPy: mocap.py:17-117."""

    def __init__(self):
        self.vertices = []

    def __str__(self):
        index = self.find_root()
        return self.branch_str(index)

    def branch_str(self, index, indent=""):
        out = indent + str(self.vertices[index]) + "\n"
        for child in self.vertices[index].children:
            out += self.branch_str(child, indent + "  ")
        return out

    def find_children(self):
        """Rebuild children lists from parents lists."""
        for v in self.vertices:
            v.children = []
        for i, v in enumerate(self.vertices):
            for p in v.parents:
                if i not in self.vertices[p].children and p != i:
                    self.vertices[p].children.append(i)

    def find_parents(self):
        """Rebuild parents lists from children lists."""
        for v in self.vertices:
            v.parents = []
        for i, v in enumerate(self.vertices):
            for c in v.children:
                if i not in self.vertices[c].parents:
                    self.vertices[c].parents.append(i)

    def find_root(self):
        """Index of the (unique) parentless vertex."""
        self.find_parents()
        roots = [i for i, v in enumerate(self.vertices) if not v.parents]
        if len(roots) != 1:
            raise ValueError(f"tree has {len(roots)} roots")
        return roots[0]

    def get_index_by_id(self, id):
        for i, v in enumerate(self.vertices):
            if v.id == id:
                return i
        raise ValueError(f"no vertex with id {id}")

    def get_index_by_name(self, name):
        for i, v in enumerate(self.vertices):
            if v.name == name:
                return i
        raise ValueError(f"no vertex named {name!r}")

    def order_vertices(self):
        """Topologically order vertices so parents precede children."""
        order = []
        stack = [self.find_root()]
        while stack:
            i = stack.pop()
            order.append(i)
            stack.extend(reversed(self.vertices[i].children))
        if len(order) != len(self.vertices):
            raise ValueError("tree contains unreachable vertices")
        remap = {old: new for new, old in enumerate(order)}
        self.vertices = [self.vertices[i] for i in order]
        for v in self.vertices:
            v.parents = [remap[p] for p in v.parents]
            v.children = [remap[c] for c in v.children]


def rotation_matrix(xangle, yangle, zangle, order="zxy", degrees=False):
    """Row-vector rotation matrix: v_rotated = v @ R.

    Composition follows the reference (GPy mocap.py:119-160): the per-axis
    matrices are left-multiplied in the order string's sequence, which for
    row vectors applies the LAST letter of `order` first. Acclaim axis/dof
    orders are therefore reversed by the parser before reaching here.
    """
    if degrees:
        xangle, yangle, zangle = map(math.radians, (xangle, yangle, zangle))
    cx, sx = math.cos(xangle), math.sin(xangle)
    cy, sy = math.cos(yangle), math.sin(yangle)
    cz, sz = math.cos(zangle), math.sin(zangle)
    mats = {
        "x": np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]]),
        "y": np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]]),
        "z": np.array([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]]),
    }
    R = np.eye(3)
    for ax in order:
        R = mats[ax] @ R
    return R


class Skeleton(Tree):
    """Tree with kinematics. GPy: mocap.py:164-196."""

    def connection_matrix(self):
        n = len(self.vertices)
        connection = np.zeros((n, n), dtype=bool)
        for i, v in enumerate(self.vertices):
            connection[i, v.children] = True
        return connection

    def to_xyz(self, channels):
        raise NotImplementedError

    def finalize(self):
        self.find_parents()
        self.order_vertices()
        self.set_rotation_matrices()

    def set_rotation_matrices(self):
        for v in self.vertices:
            axis = v.meta.get("axis", [0.0, 0.0, 0.0])
            order = v.meta.get("axis_order") or "zyx"
            v.meta["C"] = rotation_matrix(*axis, order=order, degrees=True)
            v.meta["Cinv"] = np.linalg.inv(v.meta["C"])

    def smooth_angle_channels(self, channels):
        """Unwrap 360-degree discontinuities in rotation channels in place.

        Note: this fixes the intended behavior; the reference's loop
        (GPy mocap.py:186-196) has an indentation slip that only inspects
        the final frame's difference.
        """
        for v in self.vertices:
            for col in v.meta.get("rot_ind", []):
                if col is None or col < 0:
                    continue
                for k in range(1, channels.shape[0]):
                    diff = channels[k, col] - channels[k - 1, col]
                    if abs(diff + 360.0) < abs(diff):
                        channels[k:, col] += 360.0
                    elif abs(diff - 360.0) < abs(diff):
                        channels[k:, col] -= 360.0


def _strip_comments(text):
    lines = []
    for raw in text.splitlines():
        line = raw.strip()
        if line and not line.startswith("#"):
            lines.append(line)
    return lines


class AcclaimSkeleton(Skeleton):
    """Acclaim ASF skeleton + AMC motion channels. GPy: mocap.py:204-644.

    Angles are degrees (the only units mode CMU data uses); channel columns
    are laid out per vertex in vertex order (root's `order` dofs first,
    then each bone's `dof` entries), matching the reference layout so
    rot_ind/pos_ind resolve identically.
    """

    def __init__(self, file_name=None):
        super().__init__()
        self.documentation = []
        self.name = "acclaim"
        self.angle = "deg"
        self.length = 1.0
        self.mass = 1.0
        self.type = "acclaim"
        root_meta = {
            "orientation": [0.0, 0.0, 0.0], "offset": [0.0, 0.0, 0.0],
            "axis": [0.0, 0.0, 0.0], "axis_order": "zyx",
            "C": np.eye(3), "Cinv": np.eye(3),
            "channels": [], "order": "", "rot_ind": [-1] * 3,
            "pos_ind": [-1] * 3, "limits": [],
            "xyz": np.zeros(3), "rot": np.eye(3),
        }
        self.vertices = [Vertex("root", 0, parents=[], meta=root_meta)]
        if file_name:
            self.load_skel(file_name)

    # --- parsing -----------------------------------------------------------
    def load_skel(self, file_name):
        with open(file_name) as fid:
            text = fid.read()
        self.parse_skel(text)
        self.name = file_name

    def parse_skel(self, text):
        """Parse ASF text: split on ':' section headers, then per section."""
        lines = _strip_comments(text)
        sections = {}
        current = None
        for line in lines:
            if line.startswith(":"):
                head = line[1:].split()
                current = head[0]
                sections[current] = []
                if len(head) > 1:
                    sections[current].append(" ".join(head[1:]))
            elif current is not None:
                sections[current].append(line)
        if "units" in sections:
            self._parse_units(sections["units"])
        self.documentation = sections.get("documentation", [])
        if "root" in sections:
            self._parse_root(sections["root"])
        if "bonedata" in sections:
            self._parse_bonedata(sections["bonedata"])
        if "hierarchy" in sections:
            self._parse_hierarchy(sections["hierarchy"])
        self.finalize()

    def _parse_units(self, lines):
        for line in lines:
            parts = line.split()
            if parts[0] == "mass":
                self.mass = float(parts[1])
            elif parts[0] == "length":
                self.length = float(parts[1])
            elif parts[0] == "angle":
                self.angle = parts[1]

    @staticmethod
    def _dof_to_channels(tokens):
        """dof tokens -> (channel names, reversed rotation-order string)."""
        chan_of = {
            "rx": "Xrotation", "ry": "Yrotation", "rz": "Zrotation",
            "tx": "Xposition", "ty": "Yposition", "tz": "Zposition",
            "l": "length",
        }
        channels, order = [], []
        for t in tokens:
            t = t.lower()
            channels.append(chan_of[t])
            if t in ("rx", "ry", "rz"):
                order.append(t[1])
        # reversed vs the file: rotation_matrix applies last-letter first
        return channels, "".join(order[::-1])

    def _parse_root(self, lines):
        meta = self.vertices[0].meta
        for line in lines:
            parts = line.split()
            if parts[0] == "order":
                meta["channels"], meta["order"] = self._dof_to_channels(parts[1:])
            elif parts[0] == "axis":
                meta["axis_order"] = parts[1][::-1].lower()
            elif parts[0] == "position":
                meta["offset"] = [float(x) for x in parts[1:4]]
            elif parts[0] == "orientation":
                meta["orientation"] = [float(x) for x in parts[1:4]]

    def _parse_bonedata(self, lines):
        bone = None
        direction, length, in_limits = np.zeros(3), 0.0, False
        for line in lines:
            parts = line.split()
            if parts[0] == "begin":
                bone = Vertex("", -1, meta={
                    "offset": np.zeros(3), "axis": [0.0, 0.0, 0.0],
                    "axis_order": "zyx", "C": np.eye(3), "Cinv": np.eye(3),
                    "channels": [], "order": "", "rot_ind": [-1] * 3,
                    "pos_ind": [-1] * 3, "limits": [],
                    "xyz": np.zeros(3), "rot": np.eye(3),
                })
                direction, length, in_limits = np.zeros(3), 0.0, False
            elif parts[0] == "end":
                bone.meta["offset"] = direction * length
                bone.meta["limits"] = np.array(bone.meta["limits"]) if bone.meta["limits"] else np.zeros((0, 2))
                self.vertices.append(bone)
                in_limits = False
            elif parts[0] == "id":
                bone.id = int(parts[1])
            elif parts[0] == "name":
                bone.name = parts[1]
            elif parts[0] == "direction":
                direction = np.array([float(x) for x in parts[1:4]])
            elif parts[0] == "length":
                length = float(parts[1])
            elif parts[0] == "axis":
                bone.meta["axis"] = [float(x) for x in parts[1:4]]
                bone.meta["axis_order"] = parts[-1][::-1].lower()
            elif parts[0] == "dof":
                bone.meta["channels"], bone.meta["order"] = self._dof_to_channels(parts[1:])
            elif parts[0] == "limits":
                in_limits = True
                bone.meta["limits"].append(
                    [float(parts[1].lstrip("(")), float(parts[2].rstrip(")"))])
            elif in_limits and parts[0].startswith("("):
                bone.meta["limits"].append(
                    [float(parts[0].lstrip("(")), float(parts[1].rstrip(")"))])

    def _parse_hierarchy(self, lines):
        for line in lines:
            parts = line.split()
            if parts[0] in ("begin", "end"):
                continue
            ind = self.get_index_by_name(parts[0])
            for child in parts[1:]:
                self.vertices[ind].children.append(self.get_index_by_name(child))

    # --- channel IO ---------------------------------------------------------
    def load_channels(self, file_name):
        with open(file_name) as fid:
            return self.parse_channels(fid.read())

    def parse_channels(self, text):
        """Parse AMC text into a (frames, channels) array (degrees)."""
        lines = _strip_comments(text)
        per_bone = {v.name: [] for v in self.vertices}
        n_frames = 0
        for line in lines:
            if line.startswith(":"):
                continue
            parts = line.split()
            if len(parts) == 1 and parts[0].lstrip("-").isdigit():
                n_frames += 1
                if int(parts[0]) != n_frames:
                    raise ValueError(f"unexpected frame number {parts[0]}")
            elif n_frames > 0:
                per_bone[parts[0]].append([float(x) for x in parts[1:]])
        n_channels = sum(len(v.meta["channels"]) for v in self.vertices)
        channels = np.zeros((n_frames, n_channels))
        start = 0
        for i, v in enumerate(self.vertices):
            width = len(v.meta["channels"])
            if width:
                vals = np.asarray(per_bone[v.name])
                if vals.shape != (n_frames, width):
                    raise ValueError(
                        f"bone {v.name!r}: expected {(n_frames, width)} values, got {vals.shape}")
                channels[:, start:start + width] = vals
            self._resolve_indices(i, start)
            start += width
        self.smooth_angle_channels(channels)
        return channels

    def save_channels(self, file_name, channels):
        """Write channels in AMC format. GPy: mocap.py:477-487."""
        with open(file_name, "w") as fid:
            fid.write("#!OML:ASF\n:FULLY-SPECIFIED\n:DEGREES\n")
            for frame in range(channels.shape[0]):
                fid.write(f"{frame + 1}\n")
                start = 0
                for v in self.vertices:
                    width = len(v.meta["channels"])
                    if width:
                        vals = " ".join(str(x) for x in channels[frame, start:start + width])
                        fid.write(f"{v.name} {vals}\n")
                    start += width

    def _resolve_indices(self, index, start):
        """Map this vertex's channel block to rot_ind/pos_ind columns."""
        rot_ind, pos_ind = [-1] * 3, [-1] * 3
        for i, chan in enumerate(self.vertices[index].meta["channels"]):
            kind, axis = chan[1:], "xyz".index(chan[0].lower())
            if kind == "rotation":
                rot_ind[axis] = start + i
            elif kind == "position":
                pos_ind[axis] = start + i
        self.vertices[index].meta["rot_ind"] = rot_ind
        self.vertices[index].meta["pos_ind"] = pos_ind

    # --- forward kinematics --------------------------------------------------
    def to_xyz(self, channels):
        """Joint positions (num_vertices, 3) for one frame of channels.

        Conventions match GPy mocap.py:232-298: root rotation from
        orientation + channels in axis_order; bone rotation
        R = Cinv @ Rdof @ C @ Rparent with row-vector matrices; position
        xyz = parent_xyz + offset @ R. Iterative over the topological
        vertex order (parents first) instead of recursion.
        """
        channels = np.asarray(channels).reshape(-1)
        root = self.vertices[0]
        rot_val = list(root.meta["orientation"])
        for i, rind in enumerate(root.meta["rot_ind"]):
            if rind != -1:
                rot_val[i] += channels[rind]
        root.meta["rot"] = rotation_matrix(
            *rot_val, order=root.meta["axis_order"], degrees=True)
        xyz = np.array(root.meta["offset"], dtype=float)
        for i, pind in enumerate(root.meta["pos_ind"]):
            if pind != -1:
                xyz[i] += channels[pind]
        root.meta["xyz"] = xyz
        for ind in range(1, len(self.vertices)):
            v = self.vertices[ind]
            parent = self.vertices[v.parents[0]]
            rot_val = np.zeros(3)
            for j, rind in enumerate(v.meta["rot_ind"]):
                if rind != -1:
                    rot_val[j] = channels[rind]
            Rdof = rotation_matrix(*rot_val, order=v.meta["order"], degrees=True)
            C = rotation_matrix(*v.meta["axis"], order=v.meta["axis_order"], degrees=True)
            Cinv = rotation_matrix(
                *(-np.asarray(v.meta["axis"])), order=v.meta["axis_order"][::-1], degrees=True)
            v.meta["rot"] = Cinv @ Rdof @ C @ parent.meta["rot"]
            v.meta["xyz"] = parent.meta["xyz"] + v.meta["offset"] @ v.meta["rot"]
        return np.array([v.meta["xyz"] for v in self.vertices])


# --- OSU text mocap loaders (GPy mocap.py:647-714) ---------------------------

def parse_text(file_name):
    """Parse an Ohio State University text mocap file.

    Returns ([x, y, z] arrays each (frames, markers), point_names, times).
    -9999.99 marker values become NaN (not tracked).
    """
    with open(file_name) as fid:
        header = fid.readline().split()
    point_names = np.array([name[:-2] for name in header[2:-1:3]])
    S = np.loadtxt(file_name, skiprows=1)
    times = S[:, 1]
    S = S[:, 2:]
    S[S == -9999.99] = np.nan
    points = [S[:, 0:-1:3], S[:, 1:-1:3], S[:, 2:-1:3]]
    return points, point_names, times


def read_connections(file_name, point_names):
    """Marker connection matrix from a 'nameA, nameB' csv file."""
    pairs = []
    with open(file_name) as fid:
        for line in fid:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) >= 2 and parts[0]:
                pairs.append((parts[0], parts[1]))
    index = {name: i for i, name in enumerate(point_names)}
    connect = np.zeros((len(point_names), len(point_names)), dtype=bool)
    for a, b in pairs:
        if a in index and b in index:
            connect[index[a], index[b]] = True
            connect[index[b], index[a]] = True
    return connect


def load_text_data(dataset, directory, centre=True):
    """Load an OSU run/walk dataset: markers without NaNs, centred,
    concatenated (x|y|z) and scaled by 1/400, plus the connection matrix."""
    points, point_names, _ = parse_text(os.path.join(directory, dataset + ".txt"))
    present = [i for i in range(points[0].shape[1])
               if not any(np.any(np.isnan(p[:, i])) for p in points)]
    point_names = point_names[present]
    for i in range(3):
        points[i] = points[i][:, present]
        if centre:
            points[i] = (points[i].T - points[i].mean(axis=1)).T
    Y = np.concatenate(points, axis=1) / 400.0
    connect = read_connections(os.path.join(directory, "connections.txt"), point_names)
    return Y, connect


# GPy-style lowercase aliases
vertex = Vertex
tree = Tree
skeleton = Skeleton
acclaim_skeleton = AcclaimSkeleton
