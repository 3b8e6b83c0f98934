"""Procedural kitchen object zoo (reference robocasa/models/objects/).

The port's copy of ``lipvq_tpu/robocasa/sim/objects.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

The reference samples MJCF mesh assets from a 2,114-LoC registry
(``kitchen_objects.py``) whose *semantic content* is: 153 object
categories, each with a type tuple (fruit/vegetable/receptacle/...),
five affordance attributes (graspable/washable/microwavable/cookable/
freezable), membership in one or both asset registries ("objaverse",
"aigen"), and a list of per-category model instances; plus a derived
``OBJ_GROUPS`` map (kitchen_objects.py:2052-2114) resolving group
strings to category lists.  The 5 GB asset pack is unavailable here, so
instances are primitive-geom procedural bodies (deterministic shape /
scale / color variants per instance index) carrying the same category,
group, attribute, registry and split surface:

- ``OBJ_CATEGORIES`` mirrors the reference table's types + attributes
  + registry membership entry-for-entry (kitchen_objects.py:8-2013);
- ``OBJ_GROUPS`` is built with the same rules: "all", one group per
  category, one per type, "food"/"in_container" over the edible types,
  and the custom groups (kitchen_objects.py:2052-2114);
- ``sample_kitchen_object`` honors group + exclude + attribute +
  max_size filters, ``obj_registries`` and the A/B instance ``split``
  exactly like reference kitchen_object_utils.sample_kitchen_object
  (kitchen_object_utils.py:154-400).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np

try:
    import mujoco
except ImportError:  # importable without mujoco
    mujoco = None


# =====================================================================
# category table
# =====================================================================
# attrs string: g=graspable w=washable m=microwavable c=cookable
# f=freezable; regs: "oa"=objaverse+aigen, "a"=aigen-only (reference
# kitchen_objects.py per-category aigen=/objaverse= blocks).
def _c(types, attrs, regs="oa", shape=None, hr=None, h=None, rgba=None):
    if isinstance(types, str):
        types = (types,) if types else ()
    return dict(
        types=tuple(types),
        graspable="g" in attrs,
        washable="w" in attrs,
        microwavable="m" in attrs,
        cookable="c" in attrs,
        freezable="f" in attrs,
        registries=("objaverse", "aigen") if regs == "oa" else ("aigen",),
        shape=shape,
        hr=hr,
        h=h,
        rgba=rgba,
    )


OBJ_CATEGORIES = {
    # ---- both registries (reference kitchen_objects.py:9-1196) ------
    "liquor": _c(("drink", "alcohol"), "g", "oa", "bottle", 0.035, 0.24, (0.35, 0.22, 0.12, 1)),
    "apple": _c("fruit", "gwc", "oa", "sphere", 0.033, 0.07, (0.8, 0.15, 0.1, 1)),
    "avocado": _c("vegetable", "gw", "oa", "sphere", 0.032, 0.075, (0.2, 0.35, 0.12, 1)),
    "bagel": _c("bread_food", "", "oa", "plate", 0.045, 0.03, (0.78, 0.58, 0.35, 1)),
    "bagged_food": _c("packaged_food", "f", "oa", "box", 0.05, 0.14, (0.85, 0.75, 0.55, 1)),
    "baguette": _c("bread_food", "gf", "oa", "stick", 0.14, 0.05, (0.82, 0.62, 0.35, 1)),
    "banana": _c("fruit", "gw", "oa", "stick", 0.09, 0.035, (0.92, 0.82, 0.25, 1)),
    "bar": _c("packaged_food", "gf", "oa", "box", 0.045, 0.035, (0.6, 0.4, 0.25, 1)),
    "bar_soap": _c("cleaner", "gw", "oa", "box", 0.04, 0.035, (0.9, 0.88, 0.8, 1)),
    "beer": _c(("drink", "alcohol"), "gw", "oa", "bottle", 0.032, 0.2, (0.45, 0.28, 0.12, 1)),
    "bell_pepper": _c("vegetable", "gwmcf", "oa", "sphere", 0.033, 0.085, (0.85, 0.2, 0.12, 1)),
    "bottled_drink": _c("drink", "gwf", "oa", "bottle", 0.03, 0.16, (0.3, 0.55, 0.35, 0.9)),
    "bottled_water": _c("drink", "gwf", "oa", "bottle", 0.03, 0.18, (0.75, 0.85, 0.95, 0.8)),
    "bowl": _c(("receptacle", "stackable"), "gwm", "oa", "bowl", 0.07, 0.045, (0.85, 0.9, 0.95, 1)),
    "boxed_drink": _c("drink", "gwf", "oa", "box", 0.03, 0.1, (0.7, 0.8, 0.9, 1)),
    "boxed_food": _c("packaged_food", "gmf", "oa", "box", 0.04, 0.12, (0.8, 0.65, 0.3, 1)),
    "bread": _c("bread_food", "gf", "oa", "box", 0.05, 0.06, (0.8, 0.6, 0.35, 1)),
    "broccoli": _c("vegetable", "gwmcf", "oa", "sphere", 0.033, 0.09, (0.2, 0.45, 0.15, 1)),
    "cake": _c("sweets", "gf", "oa", "cylinder", 0.06, 0.07, (0.95, 0.85, 0.8, 1)),
    "can": _c("drink", "gwf", "oa", "cylinder", 0.032, 0.11, (0.75, 0.75, 0.8, 1)),
    "candle": _c("decoration", "g", "oa", "cylinder", 0.02, 0.1, (0.95, 0.92, 0.85, 1)),
    "canned_food": _c("packaged_food", "gwmf", "oa", "cylinder", 0.032, 0.1, (0.78, 0.76, 0.78, 1)),
    "carrot": _c("vegetable", "gwmcf", "oa", "cylinder", 0.018, 0.11, (0.9, 0.45, 0.1, 1)),
    "cereal": _c("packaged_food", "g", "oa", "box", 0.05, 0.2, (0.85, 0.55, 0.25, 1)),
    "cheese": _c("dairy", "gwmcf", "oa", "box", 0.04, 0.04, (0.95, 0.8, 0.3, 1)),
    "chips": _c("packaged_food", "", "oa", "box", 0.05, 0.16, (0.9, 0.3, 0.2, 1)),
    "chocolate": _c("sweets", "f", "oa", "box", 0.04, 0.015, (0.35, 0.2, 0.12, 1)),
    "coffee_cup": _c("drink", "gm", "oa", "cylinder", 0.035, 0.1, (0.85, 0.8, 0.75, 1)),
    "condiment_bottle": _c("condiment", "gw", "oa", "bottle", 0.025, 0.14, (0.85, 0.25, 0.15, 1)),
    "corn": _c("vegetable", "gwmcf", "oa", "cylinder", 0.025, 0.13, (0.95, 0.85, 0.3, 1)),
    "croissant": _c("pastry", "gf", "oa", "box", 0.05, 0.035, (0.88, 0.68, 0.4, 1)),
    "cucumber": _c("vegetable", "gwf", "oa", "cylinder", 0.02, 0.13, (0.2, 0.5, 0.15, 1)),
    "cup": _c(("receptacle", "stackable"), "gwm", "oa", "cylinder", 0.035, 0.1, (0.6, 0.75, 0.85, 1)),
    "cupcake": _c("sweets", "gf", "oa", "cylinder", 0.03, 0.05, (0.95, 0.7, 0.75, 1)),
    "cutting_board": _c("receptacle", "w", "oa", "board", 0.16, 0.016, (0.75, 0.6, 0.4, 1)),
    "donut": _c(("sweets", "pastry"), "gf", "oa", "plate", 0.04, 0.03, (0.85, 0.55, 0.45, 1)),
    "egg": _c("dairy", "gwmcf", "oa", "sphere", 0.022, 0.05, (0.95, 0.92, 0.85, 1)),
    "eggplant": _c("vegetable", "gwmcf", "oa", "sphere", 0.033, 0.1, (0.35, 0.15, 0.4, 1)),
    "fish": _c("meat", "gwmcf", "oa", "box", 0.06, 0.04, (0.75, 0.65, 0.6, 1)),
    "fork": _c("utensil", "wmc", "oa", "stick", 0.08, 0.012, (0.75, 0.75, 0.78, 1)),
    "garlic": _c("vegetable", "gwmcf", "oa", "sphere", 0.022, 0.045, (0.92, 0.9, 0.85, 1)),
    "hot_dog": _c("cooked_food", "gmf", "oa", "stick", 0.07, 0.03, (0.8, 0.45, 0.3, 1)),
    "jam": _c("packaged_food", "gwf", "oa", "cylinder", 0.03, 0.08, (0.7, 0.2, 0.25, 1)),
    "jug": _c("receptacle", "gw", "oa", "bottle", 0.045, 0.2, (0.9, 0.9, 0.92, 1)),
    "ketchup": _c("condiment", "gw", "oa", "bottle", 0.025, 0.15, (0.8, 0.15, 0.1, 1)),
    "kettle_electric": _c("receptacle", "g", "oa", "mug", 0.07, 0.14, (0.35, 0.35, 0.38, 1)),
    "kettle_non_electric": _c("receptacle", "gw", "oa", "mug", 0.07, 0.12, (0.55, 0.55, 0.58, 1)),
    "kiwi": _c("fruit", "gwf", "oa", "sphere", 0.028, 0.055, (0.45, 0.4, 0.25, 1)),
    "knife": _c("utensil", "wmc", "oa", "knife", 0.1, 0.02, (0.3, 0.3, 0.32, 1)),
    "ladle": _c("utensil", "gwc", "oa", "stick", 0.1, 0.03, (0.5, 0.5, 0.52, 1)),
    "lemon": _c("vegetable", "gwcf", "oa", "sphere", 0.03, 0.06, (0.95, 0.88, 0.25, 1)),
    "lime": _c("vegetable", "gwcf", "oa", "sphere", 0.027, 0.054, (0.4, 0.7, 0.2, 1)),
    "mango": _c("fruit", "gwcf", "oa", "sphere", 0.033, 0.08, (0.95, 0.6, 0.2, 1)),
    "milk": _c(("dairy", "drink"), "gw", "oa", "box", 0.035, 0.16, (0.95, 0.95, 0.97, 1)),
    "mug": _c(("receptacle", "stackable"), "gwm", "oa", "mug", 0.04, 0.09, (0.85, 0.85, 0.88, 1)),
    "mushroom": _c("vegetable", "gwmcf", "oa", "sphere", 0.025, 0.05, (0.85, 0.8, 0.7, 1)),
    "onion": _c("vegetable", "gwmc", "oa", "sphere", 0.032, 0.064, (0.8, 0.65, 0.4, 1)),
    "orange": _c("fruit", "gw", "oa", "sphere", 0.033, 0.076, (0.95, 0.55, 0.1, 1)),
    "pan": _c("receptacle", "gw", "oa", "pan", 0.1, 0.035, (0.25, 0.25, 0.28, 1)),
    "pot": _c("receptacle", "gw", "oa", "pot", 0.085, 0.09, (0.55, 0.55, 0.6, 1)),
    "peach": _c("fruit", "gw", "oa", "sphere", 0.033, 0.068, (0.95, 0.65, 0.45, 1)),
    "pear": _c("fruit", "gw", "oa", "sphere", 0.033, 0.08, (0.75, 0.8, 0.35, 1)),
    "plate": _c("receptacle", "wm", "oa", "plate", 0.09, 0.02, (0.92, 0.92, 0.95, 1)),
    "potato": _c("vegetable", "gwmcf", "oa", "sphere", 0.032, 0.064, (0.7, 0.55, 0.3, 1)),
    "rolling_pin": _c("tool", "gw", "oa", "stick", 0.12, 0.035, (0.75, 0.6, 0.4, 1)),
    "scissors": _c("tool", "w", "oa", "stick", 0.07, 0.012, (0.4, 0.4, 0.45, 1)),
    "shaker": _c("condiment", "g", "oa", "cylinder", 0.02, 0.07, (0.9, 0.9, 0.92, 1)),
    "soap_dispenser": _c("cleaner", "gw", "oa", "bottle", 0.03, 0.15, (0.85, 0.88, 0.9, 0.9)),
    "spatula": _c("utensil", "wc", "oa", "stick", 0.1, 0.02, (0.2, 0.2, 0.22, 1)),
    "sponge": _c("cleaner", "gw", "oa", "box", 0.035, 0.03, (0.95, 0.85, 0.2, 1)),
    "spoon": _c("utensil", "wmc", "oa", "stick", 0.07, 0.015, (0.72, 0.72, 0.75, 1)),
    "spray": _c("cleaner", "gw", "oa", "bottle", 0.035, 0.22, (0.4, 0.65, 0.85, 1)),
    "squash": _c("vegetable", "gwmcf", "oa", "sphere", 0.033, 0.1, (0.9, 0.75, 0.3, 1)),
    "steak": _c("meat", "gwmcf", "oa", "box", 0.05, 0.038, (0.55, 0.2, 0.18, 1)),
    "sweet_potato": _c("vegetable", "gwmcf", "oa", "sphere", 0.03, 0.09, (0.7, 0.4, 0.25, 1)),
    "tangerine": _c("fruit", "gw", "oa", "sphere", 0.03, 0.06, (0.95, 0.6, 0.15, 1)),
    "teapot": _c("receptacle", "gw", "oa", "mug", 0.07, 0.1, (0.8, 0.75, 0.7, 1)),
    "tomato": _c("vegetable", "gwmc", "oa", "sphere", 0.033, 0.06, (0.88, 0.25, 0.15, 1)),
    "tray": _c("receptacle", "w", "oa", "board", 0.15, 0.02, (0.6, 0.55, 0.5, 1)),
    "waffle": _c("sweets", "mf", "oa", "plate", 0.05, 0.02, (0.85, 0.65, 0.35, 1)),
    "water_bottle": _c("drink", "gwf", "oa", "bottle", 0.03, 0.18, (0.8, 0.88, 0.95, 0.8)),
    "wine": _c(("drink", "alcohol"), "gw", "oa", "bottle", 0.035, 0.24, (0.25, 0.12, 0.18, 1)),
    "yogurt": _c(("dairy", "packaged_food"), "gwf", "oa", "cylinder", 0.03, 0.07, (0.92, 0.92, 0.95, 1)),
    # ---- aigen-only (reference kitchen_objects.py:1197-2013) --------
    "dates": _c("fruit", "wf", "a", "box", 0.03, 0.02, (0.4, 0.28, 0.18, 1)),
    "lemonade": _c("drink", "g", "a", "bottle", 0.032, 0.16, (0.95, 0.9, 0.45, 0.9)),
    "walnut": _c((), "gw", "a", "sphere", 0.02, 0.04, (0.55, 0.42, 0.3, 1)),
    "cheese_grater": _c("tool", "gw", "a", "box", 0.04, 0.12, (0.7, 0.7, 0.73, 1)),
    "syrup_bottle": _c("condiment", "g", "a", "bottle", 0.03, 0.14, (0.6, 0.35, 0.15, 1)),
    "scallops": _c("meat", "gwmcf", "a", "cylinder", 0.025, 0.025, (0.92, 0.88, 0.82, 1)),
    "candy": _c("sweets", "g", "a", "box", 0.02, 0.015, (0.9, 0.4, 0.55, 1)),
    "whisk": _c("utensil", "gw", "a", "stick", 0.09, 0.025, (0.65, 0.65, 0.68, 1)),
    "pitcher": _c("receptacle", "gwm", "a", "bottle", 0.05, 0.18, (0.85, 0.88, 0.92, 0.9)),
    "ice_cream": _c("sweets", "gf", "a", "cylinder", 0.04, 0.1, (0.92, 0.85, 0.78, 1)),
    "cherry": _c("fruit", "gwf", "a", "sphere", 0.015, 0.03, (0.7, 0.1, 0.15, 1)),
    "peanut_butter": _c("packaged_food", "gf", "a", "cylinder", 0.035, 0.09, (0.7, 0.5, 0.25, 1)),
    "thermos": _c("drink", "gwmf", "a", "cylinder", 0.035, 0.2, (0.35, 0.4, 0.5, 1)),
    "ham": _c("meat", "wmcf", "a", "cylinder", 0.05, 0.06, (0.85, 0.55, 0.5, 1)),
    "dumpling": _c(("meat", "cooked_food"), "gwmcf", "a", "sphere", 0.025, 0.035, (0.92, 0.88, 0.8, 1)),
    "cabbage": _c("vegetable", "wcf", "a", "sphere", 0.055, 0.11, (0.55, 0.7, 0.4, 1)),
    "lettuce": _c("vegetable", "wf", "a", "sphere", 0.055, 0.11, (0.45, 0.7, 0.3, 1)),
    "tongs": _c("tool", "gw", "a", "stick", 0.1, 0.02, (0.6, 0.6, 0.63, 1)),
    "ginger": _c("vegetable", "gwcf", "a", "box", 0.03, 0.03, (0.8, 0.65, 0.45, 1)),
    "ice_cube_tray": _c("receptacle", "gwf", "a", "board", 0.08, 0.025, (0.7, 0.85, 0.95, 1)),
    "shrimp": _c("meat", "wmcf", "a", "box", 0.03, 0.02, (0.95, 0.6, 0.5, 1)),
    "cantaloupe": _c("fruit", "wf", "a", "sphere", 0.07, 0.14, (0.85, 0.7, 0.45, 1)),
    "honey_bottle": _c("packaged_food", "gf", "a", "bottle", 0.03, 0.12, (0.9, 0.7, 0.25, 0.95)),
    "grapes": _c("fruit", "gwf", "a", "box", 0.035, 0.05, (0.45, 0.25, 0.45, 1)),
    "spaghetti_box": _c("packaged_food", "", "a", "box", 0.04, 0.22, (0.3, 0.45, 0.7, 1)),
    "chili_pepper": _c("vegetable", "gwmcf", "a", "cylinder", 0.012, 0.09, (0.85, 0.15, 0.1, 1)),
    "celery": _c("vegetable", "gwmcf", "a", "stick", 0.11, 0.03, (0.6, 0.8, 0.45, 1)),
    "burrito": _c("cooked_food", "gmf", "a", "cylinder", 0.03, 0.14, (0.88, 0.78, 0.55, 1)),
    "olive_oil_bottle": _c("packaged_food", "gf", "a", "bottle", 0.03, 0.2, (0.55, 0.6, 0.25, 0.9)),
    "kebabs": _c("cooked_food", "gmcf", "a", "stick", 0.1, 0.025, (0.65, 0.35, 0.22, 1)),
    "bottle_opener": _c("tool", "wf", "a", "stick", 0.05, 0.012, (0.5, 0.5, 0.53, 1)),
    "chicken_breast": _c("meat", "gwmcf", "a", "box", 0.05, 0.038, (0.95, 0.8, 0.7, 1)),
    "jello_cup": _c("packaged_food", "gf", "a", "cylinder", 0.03, 0.05, (0.85, 0.35, 0.4, 0.9)),
    "lobster": _c("meat", "gwmcf", "a", "box", 0.09, 0.04, (0.75, 0.25, 0.15, 1)),
    "brussel_sprout": _c("vegetable", "gwmcf", "a", "sphere", 0.02, 0.04, (0.45, 0.65, 0.3, 1)),
    "sushi": _c("meat", "gf", "a", "cylinder", 0.022, 0.03, (0.9, 0.88, 0.85, 1)),
    "baking_sheet": _c("receptacle", "w", "a", "board", 0.17, 0.012, (0.55, 0.52, 0.5, 1)),
    "wine_glass": _c("receptacle", "gwmf", "a", "glass", 0.035, 0.16, (0.9, 0.92, 0.95, 0.5)),
    "asparagus": _c("vegetable", "gwmcf", "a", "stick", 0.1, 0.015, (0.45, 0.65, 0.35, 1)),
    "lamb_chop": _c("meat", "gwmcf", "a", "box", 0.05, 0.038, (0.7, 0.35, 0.3, 1)),
    "pickle": _c("vegetable", "gwf", "a", "cylinder", 0.015, 0.08, (0.4, 0.55, 0.25, 1)),
    "bacon": _c("meat", "mc", "a", "stick", 0.08, 0.015, (0.75, 0.4, 0.35, 1)),
    "canola_oil": _c("packaged_food", "g", "a", "bottle", 0.035, 0.22, (0.85, 0.78, 0.4, 0.9)),
    "strawberry": _c("fruit", "gwf", "a", "sphere", 0.02, 0.04, (0.85, 0.15, 0.2, 1)),
    "watermelon": _c("fruit", "w", "a", "sphere", 0.09, 0.18, (0.25, 0.5, 0.2, 1)),
    "pizza_cutter": _c("tool", "w", "a", "stick", 0.08, 0.02, (0.6, 0.6, 0.63, 1)),
    "pomegranate": _c("fruit", "gw", "a", "sphere", 0.04, 0.08, (0.65, 0.15, 0.2, 1)),
    "apricot": _c("fruit", "gw", "a", "sphere", 0.025, 0.05, (0.95, 0.7, 0.35, 1)),
    "beet": _c("vegetable", "gwc", "a", "sphere", 0.03, 0.06, (0.5, 0.12, 0.2, 1)),
    "radish": _c("vegetable", "gw", "a", "sphere", 0.02, 0.045, (0.85, 0.3, 0.4, 1)),
    "salsa": _c("packaged_food", "g", "a", "cylinder", 0.035, 0.09, (0.75, 0.25, 0.18, 1)),
    "artichoke": _c("vegetable", "gwc", "a", "sphere", 0.04, 0.09, (0.45, 0.55, 0.35, 1)),
    "scone": _c(("pastry", "bread_food"), "g", "a", "box", 0.04, 0.035, (0.85, 0.7, 0.5, 1)),
    "hamburger": _c("cooked_food", "gm", "a", "cylinder", 0.05, 0.07, (0.8, 0.6, 0.35, 1)),
    "raspberry": _c("fruit", "wf", "a", "sphere", 0.013, 0.025, (0.8, 0.2, 0.35, 1)),
    "tacos": _c("cooked_food", "gm", "a", "box", 0.06, 0.05, (0.9, 0.75, 0.45, 1)),
    "vinegar": _c(("packaged_food", "condiment"), "g", "a", "bottle", 0.03, 0.2, (0.8, 0.75, 0.6, 0.85)),
    "zucchini": _c("vegetable", "gwmcf", "a", "cylinder", 0.022, 0.14, (0.25, 0.42, 0.18, 1)),
    "pork_loin": _c("meat", "gwmcf", "a", "box", 0.06, 0.05, (0.85, 0.6, 0.55, 1)),
    "pork_chop": _c("meat", "gwmcf", "a", "box", 0.05, 0.038, (0.85, 0.62, 0.55, 1)),
    "sausage": _c("meat", "gwmcf", "a", "cylinder", 0.015, 0.1, (0.7, 0.35, 0.25, 1)),
    "coconut": _c("fruit", "w", "a", "sphere", 0.05, 0.1, (0.5, 0.38, 0.28, 1)),
    "cauliflower": _c("vegetable", "wmcf", "a", "sphere", 0.055, 0.11, (0.92, 0.9, 0.85, 1)),
    "lollipop": _c("sweets", "", "a", "stick", 0.05, 0.02, (0.9, 0.45, 0.6, 1)),
    "salami": _c("meat", "gwmcf", "a", "cylinder", 0.025, 0.12, (0.6, 0.3, 0.25, 1)),
    "butter_stick": _c("dairy", "gmcf", "a", "box", 0.03, 0.03, (0.95, 0.9, 0.6, 1)),
    "can_opener": _c("tool", "w", "a", "stick", 0.06, 0.02, (0.45, 0.45, 0.48, 1)),
    "tofu": _c((), "gwcf", "a", "box", 0.035, 0.035, (0.95, 0.94, 0.9, 1)),
    "pineapple": _c("fruit", "wf", "a", "cylinder", 0.055, 0.16, (0.8, 0.65, 0.25, 1)),
    "skewers": _c(("meat", "cooked_food"), "gwmc", "a", "stick", 0.11, 0.02, (0.65, 0.4, 0.25, 1)),
}

assert len(OBJ_CATEGORIES) == 153, len(OBJ_CATEGORIES)

# shapes that can act as a receptacle for check_obj_in_receptacle /
# try_to_place_in (a container surface exists)
_CONTAINER_SHAPES = {"plate", "bowl", "board", "pan", "pot", "mug"}

# number of procedural instances per (category, registry) — stands in
# for the reference's per-category model.xml lists.
_N_INSTANCES = {"objaverse": 6, "aigen": 4}


# =====================================================================
# OBJ_GROUPS (reference kitchen_objects.py:2052-2114)
# =====================================================================
def get_cats_by_type(types, obj_registries=None):
    """Reference kitchen_objects.get_cats_by_type:2015-2049."""
    types = set(types)
    res = []
    for key, val in OBJ_CATEGORIES.items():
        if obj_registries is not None:
            regs = (
                [obj_registries] if isinstance(obj_registries, str) else obj_registries
            )
            if not any(r in val["registries"] for r in regs):
                continue
        if types.intersection(val["types"]):
            res.append(key)
    return res


OBJ_GROUPS = {"all": list(OBJ_CATEGORIES.keys())}
for _k in OBJ_CATEGORIES:
    OBJ_GROUPS[_k] = [_k]
_all_types = set()
for _v in OBJ_CATEGORIES.values():
    _all_types.update(_v["types"])
for _t in _all_types:
    OBJ_GROUPS[_t] = get_cats_by_type([_t])
_EDIBLE_TYPES = [
    "vegetable", "fruit", "sweets", "dairy", "meat",
    "bread_food", "pastry", "cooked_food",
]
OBJ_GROUPS["food"] = get_cats_by_type(_EDIBLE_TYPES)
OBJ_GROUPS["in_container"] = get_cats_by_type(_EDIBLE_TYPES)
# custom groups (reference kitchen_objects.py:2097-2114)
OBJ_GROUPS["container"] = ["plate"]
OBJ_GROUPS["kettle"] = ["kettle_electric", "kettle_non_electric"]
OBJ_GROUPS["cookware"] = ["pan", "pot", "kettle_non_electric"]
OBJ_GROUPS["pots_and_pans"] = ["pan", "pot"]
OBJ_GROUPS["food_set1"] = [
    "apple", "baguette", "banana", "carrot", "cheese",
    "cucumber", "egg", "lemon", "orange", "potato",
]
OBJ_GROUPS["group1"] = ["apple", "carrot", "banana", "bowl", "can"]
OBJ_GROUPS["container_set2"] = ["plate", "bowl"]


def groups_containing(category):
    """All group strings whose expansion includes ``category``
    (reference info["groups_containing_sampled_obj"])."""
    return [g for g, cats in OBJ_GROUPS.items() if category in cats]


# =====================================================================
# object spec + geometry
# =====================================================================
@dataclass
class KitchenObject:
    """One placeable object spec (reference objects.py MJCFObject)."""

    name: str  # scene-unique instance name (set at placement time)
    category: str  # e.g. "apple"
    groups: tuple  # type strings, e.g. ("vegetable",)
    horizontal_radius: float
    height: float
    rgba: tuple
    registry: str = "objaverse"
    instance: int = 0
    graspable: bool = False
    washable: bool = False
    microwavable: bool = False
    cookable: bool = False
    freezable: bool = False
    container: bool = False
    shape: str = "box"
    scale: float = 1.0

    # legacy alias (pre-round-3 engine code used "heatable")
    @property
    def heatable(self):
        return self.cookable

    @property
    def spec_str(self):
        """Serializable identity for deterministic replay
        (stored in ep_meta["object_cats"])."""
        return f"{self.category}:{self.registry}:{self.instance}"

    def _rim(self, body, box, r, wall_h, z0, n=8):
        """Octagonal rim wall approximating a hollow cylinder: each
        segment is a thin box tangent to the radius-r circle."""
        seg_half = r * math.tan(math.pi / n) * 1.05
        for i in range(n):
            ang = 2 * math.pi * i / n
            cx, cy = r * math.cos(ang), r * math.sin(ang)
            g = body.add_geom(
                name=f"{self.name}_rim{i}",
                type=mujoco.mjtGeom.mjGEOM_BOX,
                size=[0.005, seg_half, wall_h / 2],
                pos=[cx, cy, z0 + wall_h / 2],
                rgba=list(self.rgba),
            )
            g.density = 300.0
            g.quat = [math.cos(ang / 2), 0, 0, math.sin(ang / 2)]

    def build(self, spec, pos, yaw=0.0):
        """Add a free body for this object to the MjSpec."""
        body = spec.worldbody.add_body(name=self.name, pos=list(pos))
        body.quat = [math.cos(yaw / 2), 0, 0, math.sin(yaw / 2)]
        fj = body.add_joint(
            name=f"{self.name}_freejoint", type=mujoco.mjtJoint.mjJNT_FREE
        )
        del fj
        r, h = self.horizontal_radius, self.height
        rgba = list(self.rgba)

        def box(nm, size, p, rg=None):
            g = body.add_geom(
                name=nm, type=mujoco.mjtGeom.mjGEOM_BOX, size=size, pos=p,
                rgba=rg or rgba,
            )
            g.density = 300.0
            return g

        def cyl(nm, rad, hh, p, rg=None):
            g = body.add_geom(
                name=nm, type=mujoco.mjtGeom.mjGEOM_CYLINDER,
                size=[rad, hh, 0], pos=p, rgba=rg or rgba,
            )
            g.density = 300.0
            return g

        # graspable solids must FIT THE GRIPPER: the parallel fingers
        # open ~8cm, so a "graspable" category whose pinch dimension
        # exceeds that is unpickable by construction (observed: a
        # 12.5cm-wide fish slab pinched then squirted out of the
        # closing fingers on every MicrowaveThawing seed). The
        # reference's asset zoo sizes graspable meshes to the gripper;
        # mirror that by clamping the solid-shape cross-section.
        if self.graspable and self.shape in ("box", "sphere", "cylinder",
                                             None):
            r = min(r, 0.036)

        if self.shape == "sphere":
            # ellipsoid matching (r, r, h/2), tangent to the body
            # origin plane: a radius-r sphere floated at pos z=h/2
            # settles with the body origin 1.6cm BELOW the support
            # surface (for h=3r produce), so every origin-based grasp
            # height ended up too deep — the fingertips pressed into
            # the counter/basin and friction jammed them open
            # (observed on ArrangeVegetables: both finger geoms in
            # sustained contact with main_sink_2_basinbot, finger
            # joint stuck at 3mm of its 40mm travel)
            g = body.add_geom(
                name=f"{self.name}_g0",
                type=mujoco.mjtGeom.mjGEOM_ELLIPSOID,
                size=[r, r, h / 2], pos=[0, 0, h / 2], rgba=rgba,
            )
            g.density = 300.0
            # produce glides like a puck under finger nudges without
            # torsional/rolling resistance (condim 3 default): give the
            # smooth convex solids full friction so a slightly off-
            # center pinch nudges them millimetres, not across the
            # whole sink basin
            g.condim = 6
            g.friction = [1.2, 0.01, 0.002]
        elif self.shape == "cylinder":
            cyl(f"{self.name}_g0", r, h / 2, [0, 0, h / 2])
        elif self.shape == "mug":
            g = cyl(f"{self.name}_g0", r - 0.008, h / 2, [0, 0, h / 2])
            if r >= 0.055:
                # hollow-vessel mass: a solid-density cylinder made
                # kettles ~0.5kg, whose gravity torque about the handle
                # pinch rotated them out of the grip mid-lift.
                # Cup-scale mugs keep the default density — the coffee
                # experts' pinned seeds are tuned to their dynamics.
                g.density = 90.0
                # kettle-scale: body (2r up to 14cm) exceeds the 8cm
                # gripper aperture, so the handle is the only pinchable
                # feature (scripted PnPStovePolicy). It stands 22mm off
                # the wall so a 12mm finger fits in the gap, and is
                # 24mm thick radially for a torque-resisting patch.
                box(f"{self.name}_handle", [0.012, 0.018, h / 3],
                    [r + 0.028, 0, h / 2])
            else:
                # cup-scale mugs are straddle-grasped by the body; keep
                # the compact handle (a long one jams in the coffee
                # machine head during CoffeeServeMug lifts)
                box(f"{self.name}_handle", [0.006, 0.018, h / 3],
                    [r + 0.004, 0, h / 2])
        elif self.shape == "plate":
            cyl(f"{self.name}_g0", r, h / 2, [0, 0, h / 2])
        elif self.shape == "bowl":
            # hollow like pot/pan: a solid 14cm cylinder gave the
            # gripper nothing to pinch (aperture 8cm); the 1cm rim wall
            # is the graspable feature, and food can sit inside
            cyl(f"{self.name}_g0", r, 0.005, [0, 0, 0.005])
            self._rim(body, box, r, wall_h=max(h - 0.01, 0.02), z0=0.01,
                      n=8)
        elif self.shape == "pan":
            # hollow: base disc + rim wall segments — the rim gives the
            # gripper a pinchable 1cm wall and food sits inside
            cyl(f"{self.name}_g0", r, 0.006, [0, 0, 0.006])
            self._rim(body, box, r, wall_h=max(h - 0.012, 0.015),
                      z0=0.012, n=8)
            box(f"{self.name}_handle", [0.075, 0.012, 0.008], [r + 0.07, 0, h - 0.008])
        elif self.shape == "pot":
            cyl(f"{self.name}_g0", r, 0.008, [0, 0, 0.008])
            self._rim(body, box, r, wall_h=max(h - 0.016, 0.03),
                      z0=0.016, n=8)
        elif self.shape == "knife":
            box(f"{self.name}_blade", [0.07, 0.012, 0.004], [0.03, 0, 0.006],
                [0.75, 0.75, 0.78, 1])
            box(f"{self.name}_grip", [0.04, 0.01, 0.008], [-0.07, 0, 0.008])
        elif self.shape == "board":
            box(f"{self.name}_g0", [r, r * 0.7, h / 2], [0, 0, h / 2])
        elif self.shape == "stick":
            # r = half-length along x, h = thickness
            box(f"{self.name}_g0", [r, h / 2, h / 2], [0, 0, h / 2])
        elif self.shape == "bottle":
            cyl(f"{self.name}_g0", r, h * 0.35, [0, 0, h * 0.35])
            cyl(f"{self.name}_neck", r * 0.45, h * 0.15, [0, 0, h * 0.85])
        elif self.shape == "glass":
            cyl(f"{self.name}_stem", r * 0.2, h * 0.25, [0, 0, h * 0.25])
            cyl(f"{self.name}_g0", r, h * 0.25, [0, 0, h * 0.75])
        else:  # box
            box(f"{self.name}_g0", [r, r, h / 2], [0, 0, h / 2])
        return body


def _default_dims(proto):
    """Fallback shape/size/color by primary type for any category the
    table leaves unspecified."""
    t = proto["types"][0] if proto["types"] else "misc"
    table = {
        "fruit": ("sphere", 0.035, 0.07),
        "vegetable": ("sphere", 0.03, 0.06),
        "drink": ("cylinder", 0.03, 0.14),
        "receptacle": ("cylinder", 0.06, 0.06),
        "utensil": ("stick", 0.08, 0.015),
        "tool": ("stick", 0.08, 0.02),
        "meat": ("box", 0.05, 0.03),
        "sweets": ("box", 0.03, 0.04),
        "packaged_food": ("box", 0.04, 0.1),
        "dairy": ("box", 0.035, 0.05),
        "bread_food": ("box", 0.05, 0.05),
        "pastry": ("box", 0.04, 0.04),
        "cooked_food": ("box", 0.04, 0.03),
        "condiment": ("bottle", 0.025, 0.12),
        "cleaner": ("bottle", 0.03, 0.12),
        "decoration": ("cylinder", 0.02, 0.1),
        "misc": ("box", 0.03, 0.05),
    }
    return table.get(t, table["misc"])


def _hash_color(category):
    hue = int(hashlib.md5(category.encode()).hexdigest()[:4], 16) / 0xFFFF
    # pastel rgb from hue
    a = 0.55 + 0.35 * math.cos(2 * math.pi * hue)
    b = 0.55 + 0.35 * math.cos(2 * math.pi * (hue + 1 / 3))
    c = 0.55 + 0.35 * math.cos(2 * math.pi * (hue + 2 / 3))
    return (a, b, c, 1.0)


def _instance_scale(registry, instance):
    """Deterministic per-instance size variant (stands in for the
    per-model.xml mesh differences)."""
    seed = int(hashlib.md5(f"{registry}:{instance}".encode()).hexdigest()[:4], 16)
    return 0.85 + 0.30 * ((seed % 997) / 997.0)


def _instance_rgba(rgba, registry, instance):
    seed = int(hashlib.md5(f"c:{registry}:{instance}".encode()).hexdigest()[:4], 16)
    jit = 0.9 + 0.2 * ((seed % 991) / 991.0)
    r, g, b = (min(1.0, ch * jit) for ch in rgba[:3])
    return (r, g, b, rgba[3] if len(rgba) > 3 else 1.0)


def make_object(category, name, registry="objaverse", instance=0, object_scale=None):
    """Instantiate a KitchenObject.

    ``category`` may be a bare category name or a ``spec_str``
    ("cat:registry:instance") as stored in ep_meta for deterministic
    replay.
    """
    if ":" in category:
        category, registry, instance = category.split(":")
        instance = int(instance)
    proto = OBJ_CATEGORIES[category]
    shape, hr, h = proto["shape"], proto["hr"], proto["h"]
    if shape is None or hr is None:
        dshape, dhr, dh = _default_dims(proto)
        shape = shape or dshape
        hr = hr if hr is not None else dhr
        h = h if h is not None else dh
    rgba = proto["rgba"] or _hash_color(category)
    if registry not in proto["registries"]:
        registry = proto["registries"][0]
    s = _instance_scale(registry, instance)
    if object_scale is not None:
        s *= float(object_scale)
    return KitchenObject(
        name=name,
        category=category,
        groups=proto["types"],
        horizontal_radius=hr * s,
        height=h * s,
        rgba=_instance_rgba(rgba, registry, instance),
        registry=registry,
        instance=int(instance),
        graspable=proto["graspable"],
        washable=proto["washable"],
        microwavable=proto["microwavable"],
        cookable=proto["cookable"],
        freezable=proto["freezable"],
        container=shape in _CONTAINER_SHAPES,
        shape=shape,
        scale=s,
    )


def _split_instances(n, split):
    """Instance indices for split A/B.

    Reference kitchen_object_utils.py:389-398 computes
    ``split_th = max(len(choices) - 3, ceil(n/2))`` where ``choices``
    is the *registry dict* (a bug upstream: len(choices) <= 2), so the
    effective rule is split A = first ceil(n/2) instances, B = rest.
    """
    th = max(-1, int(math.ceil(n / 2)))
    if split is None:
        return list(range(n))
    if split == "A":
        return list(range(th))
    if split == "B":
        return list(range(th, n))
    raise ValueError(f"unknown split {split!r}")


def sample_kitchen_object(
    rng,
    obj_groups="all",
    exclude_obj_groups=None,
    graspable=None,
    washable=None,
    microwavable=None,
    heatable=None,
    cookable=None,
    freezable=None,
    max_size=(None, None, None),
    obj_registries=("objaverse",),
    split=None,
    object_scale=None,
):
    """Sample an object honoring group + attribute + registry + split
    filters (reference kitchen_object_utils.sample_kitchen_object:154-256).

    ``heatable`` is the legacy alias this engine used for the
    reference's ``cookable``.
    """
    if cookable is None:
        cookable = heatable
    if isinstance(obj_groups, str):
        obj_groups = (obj_groups,)
    if isinstance(exclude_obj_groups, str):
        exclude_obj_groups = (exclude_obj_groups,)
    exclude_obj_groups = exclude_obj_groups or ()
    if isinstance(obj_registries, str):
        obj_registries = (obj_registries,)

    invalid = set()
    for g in exclude_obj_groups:
        invalid.update(OBJ_GROUPS.get(g, ()))

    valid = []
    for g in obj_groups:
        if g not in OBJ_GROUPS:
            raise ValueError(f"unknown object group {g!r}")
        for cat in OBJ_GROUPS[g]:
            if cat in valid or cat in invalid:
                continue
            proto = OBJ_CATEGORIES[cat]
            if not any(r in proto["registries"] for r in obj_registries):
                continue
            ok = True
            for attr, want in (
                ("graspable", graspable),
                ("washable", washable),
                ("microwavable", microwavable),
                ("cookable", cookable),
                ("freezable", freezable),
            ):
                if want is True and not proto[attr]:
                    ok = False
            if not ok:
                continue
            valid.append(cat)

    # size filtering mirrors the reference's resample-until-fits loop
    # (kitchen_object_utils.py:205-254) but filters up front: a
    # category passes if at least one instance fits max_size.
    mw, md, mh = max_size

    def fits(cat, reg, inst):
        proto = OBJ_CATEGORIES[cat]
        hr = proto["hr"]
        h = proto["h"]
        if hr is None or h is None:
            _, hr, h = _default_dims(proto)
        s = _instance_scale(reg, inst)
        if object_scale is not None:
            s *= float(object_scale)
        if mw is not None and 2 * hr * s > mw:
            return False
        if md is not None and 2 * hr * s > md:
            return False
        if mh is not None and h * s > mh:
            return False
        return True

    candidates = []  # (cat, registry, instance)
    for cat in valid:
        proto = OBJ_CATEGORIES[cat]
        for reg in obj_registries:
            if reg not in proto["registries"]:
                continue
            for inst in _split_instances(_N_INSTANCES[reg], split):
                if fits(cat, reg, inst):
                    candidates.append((cat, reg, inst))
    if not candidates:
        raise ValueError(
            f"no object matches groups={obj_groups} excl={exclude_obj_groups} "
            f"max_size={max_size} registries={obj_registries} split={split}"
        )
    # two-stage draw like the reference: category first, instance second
    cats = sorted({c for c, _, _ in candidates})
    cat = str(rng.choice(cats))
    insts = [(r, i) for c, r, i in candidates if c == cat]
    reg, inst = insts[int(rng.integers(len(insts)))]
    return make_object(cat, name=cat, registry=reg, instance=inst,
                       object_scale=object_scale)


def object_lang(obj: KitchenObject) -> str:
    """Natural-language name (reference kitchen.py get_obj_lang:1569)."""
    return obj.category.replace("_", " ")
