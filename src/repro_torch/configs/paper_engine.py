"""The paper's own engine configuration: P=4 tuples/cycle, 32+32-bit
(group, key), operators min/max/sum/count (+ distinct count in the dc
variant), fed by a 64-bit full-width sorter.  Used by the benchmarks."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    p: int = 4                      # tuples per cycle (paper's datapath)
    tuple_bits: int = 64            # 32-bit group + 32-bit key
    ops: tuple = ("min", "max", "sum", "count")
    dc: bool = False                # "dc" variant adds distinct_count
    sorter_full_width: bool = True  # sort by (group, key), 64-bit
    freq_mhz: int = 250             # reference design clock
    tile: int = 1024                # kernel tile (lanes a tile)

    @property
    def op_list(self):
        return self.ops + (("distinct_count",) if self.dc else ())


def config() -> EngineConfig:
    return EngineConfig()


def config_dc() -> EngineConfig:
    return EngineConfig(dc=True)
