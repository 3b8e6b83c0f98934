"""MuJoCo-direct kitchen simulation layer (counterpart of
``lipvq_tpu/robocasa/sim/__init__.py``; reference robocasa L0).

A procedural rebuild of the RoboCasa kitchen environments on the
``mujoco`` runtime (no robosuite, no mesh or texture asset pack): fixtures
are primitive-geom builders over :class:`mujoco.MjSpec`, scenes are
assembled per layout and style id, and the robot is a floating-gripper
mobile base with robocasa's 12-dim action layout. ``docs/kitchen_sim.md``
lists the simplifications against the reference.

Only the single-stage tasks are ported: importing this package registers
them in ``REGISTERED_KITCHEN_ENVS``. The multi-stage package
(``lipvq_tpu/robocasa/sim/multi_stage/``) is ROADMAP §1 item 18; its task
names are listed in ``MULTI_STAGE_TASKS`` so that the env factory can name
that item for them. Every module imports without ``mujoco``; building a
kitchen then raises ``ModuleNotFoundError`` (``Kitchen.__init__``).
"""

from lipvq_tpu_torch.robocasa.sim.fixtures import (  # noqa: F401
    FixtureType,
    Fixture,
    Counter,
    SingleCabinet,
    HingeCabinet,
    OpenCabinet,
    Drawer,
    Microwave,
    Sink,
    Stove,
    CoffeeMachine,
    Fridge,
    Dishwasher,
    Hood,
)
from lipvq_tpu_torch.robocasa.sim.kitchen import (  # noqa: F401
    Kitchen,
    REGISTERED_KITCHEN_ENVS,
    register_kitchen_env,
)

# importing the task module populates REGISTERED_KITCHEN_ENVS
# (reference robocasa/environments/kitchen/__init__.py)
from lipvq_tpu_torch.robocasa.sim import single_stage as _single_stage  # noqa: E402,F401

# the task classes ``lipvq_tpu/robocasa/sim/multi_stage/`` registers
MULTI_STAGE_TASKS = frozenset((
    "AfterwashSorting", "ArrangeBreadBasket", "ArrangeTea",
    "ArrangeVegetables", "AssembleCookingArray", "BeverageOrganization",
    "BeverageSorting", "BowlAndCup", "BreadAndCheese", "BreadSelection",
    "BreadSetupSlicing", "CandleCleanup", "CerealAndBowl", "CheesyBread",
    "CleanMicrowave", "ClearClutter", "ClearingCleaningReceptacles",
    "ClearingTheCuttingBoard", "ColorfulSalsa", "CondimentCollection",
    "CountertopCleanup", "CupcakeCleanup", "DateNight", "DefrostByCategory",
    "DessertAssembly", "DessertUpgrade", "DrainVeggies", "DrawerUtensilSort",
    "DrinkwareConsolidation", "DryDishes", "DryDrinkware", "FillKettle",
    "FoodCleanup", "FryingPanAdjustment", "HeatMug", "HeatMultipleWater",
    "KettleBoiling", "MakeFruitBowl", "MakeLoadedPotato", "MealPrepStaging",
    "MeatTransfer", "MicrowaveThawing", "MultistepSteaming",
    "OrganizeBakingIngredients", "OrganizeCleaningSupplies",
    "OrganizeVegetables", "PanTransfer", "PantryMishap", "PastryDisplay",
    "PlaceFoodInBowls", "PreSoakPan", "PrepForSanitizing",
    "PrepForTenderizing", "PrepMarinatingMeat", "PrepareCoffee",
    "PrepareSoupServing", "PrepareToast", "PrewashFoodAssembly",
    "PushUtensilsToSink", "QuickThaw", "RestockBowls", "RestockPantry",
    "SearingMeat", "SeasoningSpiceSetup", "ServeSteak", "SetBowlsForSoup",
    "SetupFrying", "SetupJuicing", "ShakerShuffle", "SimmeringSauce",
    "SizeSorting", "SnackSorting", "SortingCleanup", "SpicyMarinade",
    "StackBowlsInSink", "SteamInMicrowave", "SteamVegetables",
    "StockingBreakfastFoods", "SweetSavoryToastSetup", "ThawInSink",
    "VeggieBoil", "VeggieDipPrep", "WaffleReheat", "WarmCroissant",
    "WineServingPrep", "YogurtDelightPrep",
))


def check_ported(env_name: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP §1 item 18 for a
    multi-stage task."""
    if env_name in MULTI_STAGE_TASKS:
        raise NotImplementedError(
            f"env {env_name!r}: the multi-stage kitchen tasks are not ported yet "
            f"(ROADMAP §1 item 18)")
