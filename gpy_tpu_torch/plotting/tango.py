"""Tango Desktop Project color palette (public standard scheme).

Reference: GPy/plotting/Tango.py — the same palette drives all GPy plots;
`nextMedium()` cycles through the medium shades for multi-series plots.
"""
from __future__ import annotations

colorsHex = {
    "butterLight": "#fce94f", "butterMedium": "#edd400", "butterDark": "#c4a000",
    "orangeLight": "#fcaf3e", "orangeMedium": "#f57900", "orangeDark": "#ce5c00",
    "chocolateLight": "#e9b96e", "chocolateMedium": "#c17d11", "chocolateDark": "#8f5902",
    "chameleonLight": "#8ae234", "chameleonMedium": "#73d216", "chameleonDark": "#4e9a06",
    "skyBlueLight": "#729fcf", "skyBlueMedium": "#3465a4", "skyBlueDark": "#204a87",
    "plumLight": "#ad7fa8", "plumMedium": "#75507b", "plumDark": "#5c3566",
    "scarletRedLight": "#ef2929", "scarletRedMedium": "#cc0000", "scarletRedDark": "#a40000",
    "aluminiumLight": "#eeeeec", "aluminiumMedium": "#d3d7cf", "aluminiumDark": "#babdb6",
    "greyLight": "#888a85", "greyMedium": "#555753", "greyDark": "#2e3436",
}

_medium_cycle = [
    "skyBlueMedium", "scarletRedMedium", "chameleonMedium", "orangeMedium",
    "plumMedium", "butterMedium", "chocolateMedium", "greyMedium",
]
_medium_index = [-1]


def reset():
    _medium_index[0] = -1


def currentMedium():
    return colorsHex[_medium_cycle[_medium_index[0] % len(_medium_cycle)]]


def nextMedium():
    _medium_index[0] += 1
    return currentMedium()


# the defaults used across the gpy_plot functions
BLUE = colorsHex["skyBlueDark"]
BLUE_LIGHT = colorsHex["skyBlueLight"]
GREY = colorsHex["greyMedium"]
RED = colorsHex["scarletRedMedium"]
