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


@pytest.mark.parametrize("mangled,name", [
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


def test_library_path_follows_sources_and_flags(monkeypatch):
    path = cuda_build.library_path("segmax")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libsegmax-")
    assert cuda_build.library_path("segmax") == path
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("segmax") != path
