"""Small models that carry every contact family of the lane step.

``small_manipulation`` builds a model with the manipulation families
(sphere-sphere, sphere-world and box-face-sphere pairs) beside
sphere-halfspace, sphere-box and box-face-halfspace ones, and
``manipulation_states`` seeded states for it.  The builder takes the
model and geometry modules as arguments (``multibody.model`` and
``contact.geometry`` of this package, or any with the same interface),
so one description can build matching models for a comparison.  The
kernels' checks on the card and the CPU tests use them.
"""

import numpy as np


def small_manipulation(model_mod, geom_mod, families=("ss", "sw", "bs"),
                       **finalize):
    """A free torso carrying a box, a revolute leg with a fixed foot
    sphere, a fixed world box and a ground halfspace (sh, sb and bh
    pairs), with the manipulation families: ``ss`` adds a free ball at a
    corner of the torso box and a bumper sphere on the torso beside it
    (sphere-sphere pairs between the bodies' spheres), ``sw`` a fixed
    world sphere beside the ball, ``bs`` the box-face quadrature for the
    torso box against body spheres (8 corners a pair; without it those
    pairs are sb).  The foot and the torso do not collide."""
    mb = model_mod.ModelBuilder()
    I = lambda a, b, c: np.diag([a, b, c])
    torso = mb.add_body("torso", -1, model_mod.FREE, mass=2.0,
                        inertia=I(0.01, 0.02, 0.025))
    hip = mb.add_body("hip", torso, model_mod.REVOLUTE,
                      X_PJ_pos=(0.1, 0.0, -0.04), axis=(0.0, 1.0, 0.0),
                      mass=0.3, com=(0.0, 0.0, -0.07),
                      inertia=I(1e-3, 1e-3, 2e-4), damping=0.1,
                      armature=0.01, actuated=True)
    foot = mb.add_body("foot", hip, model_mod.FIXED,
                       X_PJ_pos=(0.0, 0.0, -0.15), mass=0.05,
                       inertia=I(1e-5, 1e-5, 1e-5))
    ball = (mb.add_body("ball", -1, model_mod.FREE, mass=0.25,
                        inertia=I(4e-4, 4e-4, 4e-4))
            if "ss" in families else None)
    gs = geom_mod.GeometrySet()
    G = geom_mod.CollisionGeometry
    soft = geom_mod.ContactProps(modulus=2e6, dissipation=0.5,
                                 mu_static=0.8, mu_dynamic=0.6)
    gs.add(G(torso, geom_mod.BOX, np.zeros(3), np.eye(3),
             np.array([0.15, 0.08, 0.04]), soft))
    gs.add(G(foot, geom_mod.SPHERE, np.zeros(3), np.eye(3),
             np.array([0.02]), soft))
    if ball is not None:
        gs.add(G(torso, geom_mod.SPHERE, np.array([0.115, 0.1, 0.04]),
                 np.eye(3), np.array([0.02]), soft))
        gs.add(G(ball, geom_mod.SPHERE, np.zeros(3), np.eye(3),
                 np.array([0.05]), soft))
    if "sw" in families:
        gs.add(G(-1, geom_mod.SPHERE, np.array([0.285, 0.11, 0.07]),
                 np.eye(3), np.array([0.06]),
                 geom_mod.ContactProps(modulus=4e6)))
    gs.add(G(-1, geom_mod.BOX, np.array([0.18, 0.2, 0.02]), np.eye(3),
             np.array([0.1, 0.05, 0.02]), geom_mod.ContactProps(modulus=3e6)))
    gs.add(G(-1, geom_mod.HALFSPACE, np.zeros(3), np.eye(3), np.zeros(1),
             geom_mod.ContactProps(modulus=5e6)))
    gs.exclude_body_pair(foot, torso)
    return (mb.finalize(**finalize),
            geom_mod.build_contact_model(
                gs, box_face_quadrature="bs" in families, **finalize))


def manipulation_states(model, B, seed):
    """(x (n, B), u (m, B)) float64 numpy for small_manipulation: the
    torso's box face at the ground, random hip angles, the ball (if any)
    at the box's (+x, +y, +z) corner, on the world box and touching the
    world sphere, random velocities."""
    rng = np.random.default_rng(seed)
    x = np.zeros((model.nq + model.nv, B))
    quat = np.array([1.0, 0.0, 0.0, 0.0])[:, None] + 0.1 * \
        rng.standard_normal((4, B))
    x[:4] = quat / np.linalg.norm(quat, axis=0)
    x[4:6] = 0.02 * rng.standard_normal((2, B))
    x[6] = 0.04 + np.linspace(-0.01, 0.01, B)
    x[7] = rng.uniform(-np.pi, np.pi, B)
    if model.nq > 8:                                   # the ball
        x[8] = 1.0
        x[12:15] = (np.array([0.18, 0.11, 0.07])[:, None]
                    + 0.01 * rng.standard_normal((3, B)))
    x[model.nq:] = 0.5 * rng.standard_normal((model.nv, B))
    u = rng.standard_normal((model.nu, B))
    return x, u
