"""Named quadric shapes → implicit coefficients (a,b,c,d,e,f)
(txr/scene/surface_factory.py, after SurfaceFactory, Surface.h:7-97).

The quadric is a·x² + b·y² + c·z² + d·z + e·y + f = 0 in the primitive's
rotated local frame; semi-axis arguments map to ``axis**-2`` coefficients.
"""

from __future__ import annotations


def ellipsoid(a, b, c):
    """x²/a² + y²/b² + z²/c² = 1."""
    return (a ** -2.0, b ** -2.0, c ** -2.0, 0.0, 0.0, -1.0)


def elliptic_paraboloid(a, b):
    """x²/a² + y²/b² = z."""
    return (a ** -2.0, b ** -2.0, 0.0, -1.0, 0.0, 0.0)


def hyperbolic_paraboloid(a, b):
    """x²/a² − y²/b² = z."""
    return (a ** -2.0, -(b ** -2.0), 0.0, -1.0, 0.0, 0.0)


def elliptic_hyperboloid_one_sheet(a, b, c):
    """x²/a² + y²/b² − z²/c² = 1."""
    return (a ** -2.0, b ** -2.0, -(c ** -2.0), 0.0, 0.0, -1.0)


def elliptic_hyperboloid_two_sheets(a, b, c):
    """x²/a² + y²/b² − z²/c² = −1."""
    return (a ** -2.0, b ** -2.0, -(c ** -2.0), 0.0, 0.0, 1.0)


def elliptic_cone(a, b, c):
    """x²/a² + y²/b² − z²/c² = 0."""
    return (a ** -2.0, b ** -2.0, -(c ** -2.0), 0.0, 0.0, 0.0)


def elliptic_cylinder(a, b):
    """x²/a² + y²/b² = 1."""
    return (a ** -2.0, b ** -2.0, 0.0, 0.0, 0.0, -1.0)


def hyperbolic_cylinder(a, b):
    """x²/a² − y²/b² = 1."""
    return (a ** -2.0, -(b ** -2.0), 0.0, 0.0, 0.0, -1.0)


def parabolic_cylinder(a):
    """x² + 2a·y = 0."""
    return (1.0, 0.0, 0.0, 0.0, 2.0 * a, 0.0)


ALL = {
    "ellipsoid": ellipsoid,
    "elliptic_paraboloid": elliptic_paraboloid,
    "hyperbolic_paraboloid": hyperbolic_paraboloid,
    "elliptic_hyperboloid_one_sheet": elliptic_hyperboloid_one_sheet,
    "elliptic_hyperboloid_two_sheets": elliptic_hyperboloid_two_sheets,
    "elliptic_cone": elliptic_cone,
    "elliptic_cylinder": elliptic_cylinder,
    "hyperbolic_cylinder": hyperbolic_cylinder,
    "parabolic_cylinder": parabolic_cylinder,
}
