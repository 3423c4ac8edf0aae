"""The kernel build's bookkeeping on the CPU: the ptxas report that
``chip_smoke.py`` records for every kernel (registers, spill bytes, shared
memory, by demangled name) and the library path keyed on sources and
flags.  Nothing is compiled: the log below is ptxas's own format."""

import pytest

from fashionvisualexpl_tpu_torch.ops import cuda_build

NS = "_ZN41_GLOBAL__N__c08ccf65_9_segmax_cu_8c212886"
WG = f"{NS}19segmax_wgmma_kernelILi10ELi16EEEvNS_7MmaArgsE"
SIMT = f"{NS}18segmax_simt_kernelI13__nv_bfloat16EEvPKT_S4_PKfPfixiixiiix"
LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{WG}' for 'sm_90a'
ptxas info    : Function properties for {WG}
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '{SIMT}' for 'sm_90a'
ptxas info    : Function properties for {SIMT}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 35840 bytes smem
"""


def test_ptxas_report_reads_each_kernel():
    rows = cuda_build.ptxas_report(LOG)
    assert rows == [
        dict(kernel="segmax_wgmma_kernel<10, 16>", registers=128, spill_stores=8,
             spill_loads=12, smem=0),
        dict(kernel="segmax_simt_kernel<__nv_bfloat16>", registers=64, spill_stores=0,
             spill_loads=0, smem=35840),
    ]
    assert cuda_build.ptxas_report("") == []


GNS = "_ZN41_GLOBAL__N__5d0c1e2f_9_gather_cu_7a3b9c1d"


@pytest.mark.parametrize("mangled,name", [
    (f"{GNS}19gather_lanes_kernelIjLi8EEEvPKT_PKiPS1_xix",
     "gather_lanes_kernel<unsigned int, 8>"),
    (f"{GNS}19gather_lanes_kernelIjLi16EEEvPKT_PKiPS1_xix",
     "gather_lanes_kernel<unsigned int, 16>"),
    (f"{GNS}19gather_lanes_kernelI5uint4Li4EEEvPKT_PKiPS2_xix",
     "gather_lanes_kernel<uint4, 4>"),
    (f"{GNS}18gather_bulk_kernelILb1EEEvNS_8BulkArgsE", "gather_bulk_kernel<1>"),
    (f"{GNS}18gather_bulk_kernelILb0EEEvNS_8BulkArgsE", "gather_bulk_kernel<0>"),
    (f"{NS}22segmax_mma_regs_kernelILi8ELi32EEEvNS_7MmaArgsE",
     "segmax_mma_regs_kernel<8, 32>"),
    (f"{NS}17segmax_mma_kernelILi0EEEvNS_7MmaArgsE", "segmax_mma_kernel<0>"),
    (f"{NS}17segmax_mma_kernelILb1ELi8EEEvNS_7MmaArgsE", "segmax_mma_kernel<1, 8>"),
    (f"{NS}18segmax_simt_kernelIfEEvPKT_S2_PKfPfixiixiiix", "segmax_simt_kernel<float>"),
    ("_ZN46_GLOBAL__N__9b4e7771_13_edge_tower_cu_6bdffb9515edge_bwd_kernelE"
     "PKfS1_S1_S1_Pfiiiiiiixf", "edge_bwd_kernel"),
    ("_Z10adam_sweepPfS_S_PKfi", "adam_sweep"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_names_are_demangled(mangled, name):
    assert cuda_build._kernel_name(mangled) == name


def test_ptxas_report_reads_the_gather_kernels():
    """The row gather's kernels by name, with their static shared memory
    (the lanes kernels' staged row offsets; the bulk kernels' ring is
    dynamic) and spills."""
    lanes = f"{GNS}19gather_lanes_kernelIjLi8EEEvPKT_PKiPS1_xix"
    bulk = f"{GNS}18gather_bulk_kernelILb0EEEvNS_8BulkArgsE"
    log = f"""ptxas info    : Compiling entry function '{lanes}' for 'sm_90a'
ptxas info    : Function properties for {lanes}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 2048 bytes smem
ptxas info    : Compiling entry function '{bulk}' for 'sm_90a'
ptxas info    : Function properties for {bulk}
    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 38 registers
"""
    assert cuda_build.ptxas_report(log) == [
        dict(kernel="gather_lanes_kernel<unsigned int, 8>", registers=40, spill_stores=0,
             spill_loads=0, smem=2048),
        dict(kernel="gather_bulk_kernel<0>", registers=38, spill_stores=4, spill_loads=4,
             smem=0),
    ]


def test_library_path_follows_sources_and_flags(monkeypatch):
    path = cuda_build.library_path("segmax")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libsegmax-")
    assert cuda_build.library_path("segmax") == path
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("segmax") != path
